"""The PyTorch port stands alone: every module of ``ppocr_tpu_torch`` and
``chip_smoke.py`` imports with jax, cv2 and PIL blocked, and loads nothing
of the JAX package ``ppocr_tpu``."""

import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys
    for name in ("jax", "jaxlib", "cv2", "PIL"):
        sys.modules[name] = None  # any import of them raises ImportError
    import ppocr_tpu_torch
    names = ["ppocr_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ppocr_tpu_torch.__path__, "ppocr_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if m == "ppocr_tpu" or m.startswith("ppocr_tpu."))
    assert not leaked, leaked
    print(len(names))
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
    assert int(out.stdout.split()[-1]) >= 15  # every module was visited
