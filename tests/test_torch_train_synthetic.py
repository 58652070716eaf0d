"""The port's synthetic training scripts, on the CPU.

``scripts/train_synthetic_rec_torch.py --scene-crops --alphabet jumbo``
and ``scripts/train_synthetic_det_torch.py --alphabet jumbo`` take two
steps with ``--device cpu``. The first step's loss (printed to six
decimals) is the loss of the first batch at the initial parameters, so it
is held to the JAX package's ``ctc_train_loss`` / ``det_train_loss`` on
the JAX package's first batch of the same dataset and seed, at the train
parity tests' rtol 1e-5; the npz each writes must load and serve in the
port's engine. The modes that read the reference charset take it from
``--charset-file`` (a small one written here) and start from the JAX
loss too; without the flag they raise ``ReferenceCharsetMissing``. The
cv2-font modes (``--alphabet digits`` of both scripts, direct lines and
scene crops, and the direct ``ascii`` lines) take a step on the CPU from
the JAX loss of the JAX package's first batch; the direct ``full`` lines
(Greek, which cv2 draws from WenQuanYi) raise ``CV2FallbackFaceNotPorted``
(ROADMAP A17) before any step. Without ``--device`` the scripts want a
card.
"""

import functools
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ppocr_tpu.train.synthetic as J
from ppocr_tpu.models import init_rec_params as jax_init_rec_params
from ppocr_tpu.models.det_db import init_det_params as jax_init_det_params
from ppocr_tpu.train.finetune import charset_classes, reinit_ctc_head
from ppocr_tpu.pipeline.charset import load_charset
from ppocr_tpu.train.trainer import ctc_train_loss, det_train_loss
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.pipeline.config import PipelineConfig
from ppocr_tpu_torch.pipeline.engine import OCREngine
from ppocr_tpu_torch.pipeline.worker import OCRWorker
from ppocr_tpu_torch.train.synthetic import CV2FallbackFaceNotPorted, ReferenceCharsetMissing

REPO = pathlib.Path(__file__).resolve().parent.parent
REC = REPO / "scripts" / "train_synthetic_rec_torch.py"
DET = REPO / "scripts" / "train_synthetic_det_torch.py"


def run(script, *args):
    out = subprocess.run([sys.executable, str(script), *args], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    return out.stdout


def first_loss(stdout: str) -> float:
    return float(re.search(r"step\s+1\s+loss\s+(\S+)", stdout).group(1))


def load_script(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serve_one_scene(model_dir) -> list:
    cfg = PipelineConfig.from_dict(assets.load_goldens()["configs"]["small"])
    worker = OCRWorker(OCREngine(str(model_dir), cfg, device="cpu"), 0)
    return worker.process(assets.load_scenes()["parity"][0], 0)["words"]


def test_rec_script_trains_from_the_jax_first_batch_and_serves(tmp_path):
    out = tmp_path / "rec.npz"
    stdout = run(REC, "--scene-crops", "--alphabet", "jumbo", "--steps", "2", "--batch", "4",
                 "--img-w", "64", "--device", "cpu", "--out", str(out))
    assert "eval: " in stdout and "saved weights" in stdout
    charset = charset_classes(list(J.jumbo_alphabet()))
    ds = J.SceneCropRecDataset(charset, J.text_scene_dataset("jumbo", seed=7), img_h=48, img_w=64)
    batch, _ = ds.batch(4)
    params = reinit_ctc_head(jax_init_rec_params(seed=0), len(charset), seed=0)
    want = float(jax.jit(ctc_train_loss)(params, batch))
    np.testing.assert_allclose(first_loss(stdout), want, rtol=1e-5)

    md = assets.make_jumbo_model_dir(tmp_path / "md")
    (md / "rec" / "weights.npz").write_bytes(out.read_bytes())
    words = serve_one_scene(md)
    assert isinstance(words, list)


def test_det_script_trains_from_the_jax_first_batch_and_serves(tmp_path):
    out = tmp_path / "det.npz"
    stdout = run(DET, "--alphabet", "jumbo", "--steps", "2", "--batch", "2", "--eval-scenes", "2",
                 "--device", "cpu", "--out", str(out))
    assert "eval over 2 scenes" in stdout and "saved weights" in stdout
    batch, _ = J.text_scene_dataset("jumbo", seed=0).det_batch(2)
    want = float(jax.jit(det_train_loss)(jax_init_det_params(seed=0), batch))
    np.testing.assert_allclose(first_loss(stdout), want, rtol=1e-5)

    md = assets.make_jumbo_model_dir(tmp_path / "md")
    (md / "det" / "weights.npz").write_bytes(out.read_bytes())
    assert isinstance(serve_one_scene(md), list)


# a reference-style charset for the ascii and full modes: ASCII, non-ASCII
# entries DejaVuSans draws and one it lacks
CHARSET_LINES = list(J.ASCII_ALPHABET) + list("αβΩЖжéÅ€±→") + ["中"]


@pytest.fixture
def charset_file(tmp_path, monkeypatch):
    """The file ``--charset-file`` names; the JAX package's own scripts
    read the reference charset from a fixed path, so its
    ``dejavu_alphabet`` is pointed at the same file."""
    path = tmp_path / "keys.txt"
    path.write_text("\n".join(CHARSET_LINES) + "\n", encoding="utf-8")
    monkeypatch.setattr(J, "dejavu_alphabet", functools.partial(J.dejavu_alphabet, str(path)))
    return str(path)


@pytest.mark.parametrize("mode", ["ascii", "full"])
def test_rec_script_reads_the_charset_file_and_starts_from_the_jax_loss(tmp_path, charset_file,
                                                                        mode):
    stdout = run(REC, "--scene-crops", "--alphabet", mode, "--charset-file", charset_file,
                 "--steps", "1", "--batch", "4", "--img-w", "64", "--eval-batches", "1",
                 "--device", "cpu", "--out", str(tmp_path / "rec.npz"))
    charset = load_charset(charset_file)
    ds = J.SceneCropRecDataset(charset, J.text_scene_dataset(mode, seed=7), img_h=48, img_w=64)
    batch, _ = ds.batch(4)
    params = reinit_ctc_head(jax_init_rec_params(seed=0), len(charset), seed=0)
    want = float(jax.jit(ctc_train_loss)(params, batch))
    np.testing.assert_allclose(first_loss(stdout), want, rtol=1e-5)


def test_det_script_reads_the_charset_file_and_starts_from_the_jax_loss(tmp_path, charset_file):
    stdout = run(DET, "--alphabet", "ascii", "--charset-file", charset_file, "--steps", "1",
                 "--batch", "2", "--eval-scenes", "1", "--device", "cpu",
                 "--out", str(tmp_path / "det.npz"))
    batch, _ = J.text_scene_dataset("ascii", seed=0).det_batch(2)
    want = float(jax.jit(det_train_loss)(jax_init_det_params(seed=0), batch))
    np.testing.assert_allclose(first_loss(stdout), want, rtol=1e-5)


def jax_first_loss(path, extra, charset_file):
    """The JAX loss of the JAX package's first batch of the dataset the
    script draws from, at the scripts' initial parameters."""
    if path == DET:
        batch, _ = J.SyntheticSceneDataset(seed=0).det_batch(2)
        return float(jax.jit(det_train_loss)(jax_init_det_params(seed=0), batch))
    charset = load_charset(charset_file)
    if "--scene-crops" in extra:
        ds = J.SceneCropRecDataset(charset, J.SyntheticSceneDataset(seed=7), img_h=48, img_w=64)
    else:
        alphabet = "0123456789" if "digits" in extra else J.dejavu_alphabet(ascii_only=True)
        ds = J.SyntheticRecDataset(charset, alphabet=alphabet, img_h=48, img_w=64)
    batch, _ = ds.batch(4)
    params = reinit_ctc_head(jax_init_rec_params(seed=0), len(charset), seed=0)
    return float(jax.jit(ctc_train_loss)(params, batch))


@pytest.mark.parametrize("path,extra", [
    (REC, ["--alphabet", "digits"]),
    (REC, ["--alphabet", "digits", "--scene-crops"]),
    (DET, ["--alphabet", "digits"]),
    (REC, ["--alphabet", "ascii"]),
], ids=["rec_lines", "rec_scene_crops", "det", "rec_ascii_lines"])
def test_the_cv2_font_modes_train_from_the_jax_loss(tmp_path, charset_file, path, extra):
    if path == DET:
        args = ["--batch", "2", "--eval-scenes", "1"]
    else:
        args = ["--batch", "4", "--img-w", "64", "--charset-file", charset_file]
    stdout = run(path, *extra, *args, "--steps", "1", "--device", "cpu", "--out", str(tmp_path / "w.npz"))
    assert "saved weights" in stdout
    np.testing.assert_allclose(first_loss(stdout), jax_first_loss(path, extra, charset_file), rtol=1e-5)


def test_the_full_lines_are_refused_before_a_step(tmp_path, charset_file):
    with pytest.raises(CV2FallbackFaceNotPorted, match="A17"):
        load_script(REC).main(["--alphabet", "full", "--charset-file", charset_file, "--device", "cpu",
                               "--steps", "1", "--out", str(tmp_path / "w.npz")])
    assert not (tmp_path / "w.npz").exists()


@pytest.mark.parametrize("path,args", [
    (REC, ["--alphabet", "ascii", "--scene-crops"]),
    (REC, ["--alphabet", "full"]),
    (DET, ["--alphabet", "ascii"]),
], ids=["rec_ascii", "rec_full", "det_ascii"])
def test_the_reference_charset_modes_want_a_charset_file(tmp_path, path, args):
    with pytest.raises(ReferenceCharsetMissing, match="ppocr_keys_v1.txt.*--charset-file"):
        load_script(path).main([*args, "--device", "cpu", "--steps", "1",
                                "--out", str(tmp_path / "w.npz")])
    assert not (tmp_path / "w.npz").exists()


@pytest.mark.parametrize("path,args", [(REC, ["--scene-crops"]), (DET, [])], ids=["rec", "det"])
def test_out_is_required(path, args, capsys):
    with pytest.raises(SystemExit):
        load_script(path).main(["--alphabet", "jumbo", "--device", "cpu", *args])
    assert "--out" in capsys.readouterr().err


def test_jumbo_without_scene_crops_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        load_script(REC).main(["--alphabet", "jumbo", "--device", "cpu",
                               "--out", str(tmp_path / "w.npz")])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
@pytest.mark.parametrize("path,args", [(REC, ["--scene-crops"]), (DET, [])], ids=["rec", "det"])
def test_the_scripts_want_a_card_by_default(tmp_path, path, args):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_script(path).main(["--alphabet", "jumbo", "--out", str(tmp_path / "w.npz"), *args])
