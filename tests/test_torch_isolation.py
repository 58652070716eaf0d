"""The PyTorch port stands alone: every module of ``ppocr_tpu_torch``,
``chip_smoke.py`` and the port's scripts ``scripts/soak_torch.py``,
``scripts/measure_boot_torch.py``, ``scripts/train_synthetic_rec_torch.py``,
``scripts/train_synthetic_det_torch.py`` and
``scripts/time_cv2_text_torch.py``, ``scripts/time_jpeg2000_torch.py`` and
``scripts/time_avif_torch.py``
import with jax, cv2, PIL, fontTools and glymur blocked, and load nothing of the
JAX package ``ppocr_tpu``; the glyph atlas reads and draws there too, and
so does cv2's text drawing (``train/cv2_text.py`` from
``assets/cv2_text.npz``, its C++ built at first use), and the committed
JPEG 2000 and AVIF cases decode to cv2's stored answers
(``csrc/jpeg2000.cpp``, ``csrc/av1.cpp``). Only the generators,
``scripts/make_glyph_atlas_torch.py`` (PIL and fontTools),
``scripts/make_cv2_text_assets_torch.py`` (cv2 and fontTools) and
``scripts/make_av1_tables_torch.py`` (cv2, to find its libaom), import
them."""

import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys
    for name in ("jax", "jaxlib", "cv2", "PIL", "fontTools", "glymur"):
        sys.modules[name] = None  # any import of them raises ImportError
    import ppocr_tpu_torch
    names = ["ppocr_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ppocr_tpu_torch.__path__, "ppocr_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    scripts = ("soak_torch", "measure_boot_torch", "train_synthetic_rec_torch",
               "train_synthetic_det_torch", "time_cv2_text_torch", "time_jpeg2000_torch", "time_avif_torch")
    for script in scripts:  # their imports sit at the top
        spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    from ppocr_tpu_torch.train import text_render
    font = text_render.load_atlas().font("DejaVuSans.ttf", 28)
    assert font.getbbox("Ab") == (0, 5, 37, 26), font.getbbox("Ab")  # Pillow's textbbox
    import numpy as np
    from ppocr_tpu_torch.train import cv2_text
    assert cv2_text.get_text_size("0123", 0, 1.0, 2) == ((73, 27), 1)  # cv2.getTextSize
    img = cv2_text.put_text(np.full((40, 90, 3), 255, np.uint8), "0123", (5, 30), 0, 1.0, (0, 0, 0), 2)
    assert int(img.sum()) == 2175876, int(img.sum())  # cv2.putText's pixels
    from ppocr_tpu_torch import assets
    from ppocr_tpu_torch.utils import imcodec
    j2k = {k: v for k, v in assets.load_image_cases().items() if k.startswith("jpeg2000_") and v[1] is not None}
    assert len(j2k) >= 20
    for name, (data, want) in j2k.items():  # csrc/jpeg2000.cpp built at first use
        assert (imcodec.decode_image(data) == want).all(), name
    avif = {k: v for k, v in assets.load_image_cases().items() if k.startswith("avif_") and v[1] is not None}
    assert len(avif) >= 20
    for name, (data, want) in avif.items():  # csrc/av1.cpp built at first use
        assert (imcodec.decode_image(data) == want).all(), name
    leaked = sorted(m for m in sys.modules if m == "ppocr_tpu" or m.startswith("ppocr_tpu."))
    assert not leaked, leaked
    print(" ".join(names))
    """
)


def test_port_imports_without_jax_cv2_pil_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 40  # every module was visited
    for module in ("ops.native", "ops.geometry", "ops.db_postprocess", "pipeline.sysinfo",
                   "serve.balancer", "pipeline.engine", "pipeline.worker", "train.trainer",
                   "train.finetune", "cli.finetune_main", "utils.imcodec",
                   "parallel.tensor_parallel", "parallel.dryrun", "utils.visualize",
                   "utils.draw", "ops.structure", "train.synthetic", "train.text_render",
                   "train.eval_jumbo", "train.cv2_text", "train.eval_digits"):
        assert f"ppocr_tpu_torch.{module}" in names
