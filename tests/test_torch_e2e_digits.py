"""The trained-digits gate's scenes served by the port, on the CPU.

The JAX package's digits gate (``tests/test_e2e_trained.py``) serves 12
scenes of ``SyntheticSceneDataset(seed=424)`` (cv2 Hershey digit lines,
which the port draws through ``train/cv2_text.py``) through the bundled
``det_synthetic_digits.npz`` + ``rec_scene_digits.npz`` on the staged and
the fused path, and scores the texts it reads. Its bars need the reference
charset to tell which of the 6,625 head classes is which digit, and the
repo does not hold it; so here the port (``OCREngine(..., device="cpu")``)
and the JAX package's ``OCRWorker`` serve the same scenes from the same
weights-only bundle with a placeholder keys file
(``assets.make_digits_model_dir``), config for config
(``train.eval_digits``), and:

* the scenes' placed lines are the JAX package's;
* the JAX package's words equal ``assets/digits_words.json`` (texts and
  boxes exactly, confidences within 1e-6);
* the port's words equal them: the same count and texts, boxes within
  2 px, confidences within 2e-3 (the bars of the goldens).

``chip_smoke.py`` (phase "cv2 digits") holds the card's words to the same
file. ``python tests/test_torch_e2e_digits.py --write`` rewrites it.
"""

import dataclasses
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import pytest

from ppocr_tpu_torch import assets
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
from ppocr_tpu_torch.train import eval_digits as G

from test_torch_goldens import few_torch_threads, jax_config  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PATHS = ("staged", "fused")
BOX_TOL = 2
SCORE_TOL = 2e-3


def config(path):
    return G.gate_config() if path == "staged" else G.fused_config()


def jax_words(model_dir, path):
    from ppocr_tpu.pipeline import OCREngine as JaxEngine
    from ppocr_tpu.pipeline import OCRWorker as JaxWorker
    from ppocr_tpu.train.synthetic import SyntheticSceneDataset

    eng = JaxEngine(str(model_dir), jax_config(dataclasses.asdict(config(path))))
    assert eng.random_weights == {"det": False, "rec": False}
    eng.post.backend = "cv2"
    worker, ds = JaxWorker(eng, 0), SyntheticSceneDataset(seed=G.SEED)
    out = []
    for s in range(G.N_SCENES):
        scene, placed = ds.sample_scene()
        r = worker.process(scene, s)
        assert r["success"] is True
        out.append({"placed": [[t, list(b)] for t, b in placed], "words": r["words"]})
    return out


def check_words(got, want, box_tol=BOX_TOL, score_tol=SCORE_TOL):
    """A path's served scenes against the committed ones."""
    assert len(got) == len(want) == G.N_SCENES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["placed"] == w["placed"], i
        assert [x["text"] for x in g["words"]] == [x["text"] for x in w["words"]], i
        for a, b in zip(g["words"], w["words"]):
            assert np.abs(np.asarray(a["box"]) - np.asarray(b["box"])).max() <= box_tol, (i, a, b)
            assert abs(a["confidence"] - b["confidence"]) <= score_tol, (i, a, b)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return assets.make_digits_model_dir(tmp_path_factory.mktemp("digits"))


def test_committed_words_are_the_gate_protocol():
    words = assets.load_digits_words()
    assert (words["seed"], words["scenes"]) == (G.SEED, G.N_SCENES)
    n_lines = sum(len(s["placed"]) for s in words["staged"])
    assert n_lines >= 15  # the JAX gate's own floor on its line count
    for path in PATHS:
        assert [s["placed"] for s in words[path]] == [s["placed"] for s in words["staged"]]
        assert sum(len(s["words"]) for s in words[path]) >= n_lines - 2


@pytest.mark.parametrize("path", PATHS)
def test_jax_words_equal_the_committed(model_dir, path):
    check_words(jax_words(model_dir, path), assets.load_digits_words()[path], box_tol=0, score_tol=1e-6)


@pytest.mark.parametrize("path", PATHS)
def test_port_words_equal_the_jax_package(model_dir, path):
    eng = OCREngine(str(model_dir), config(path), device="cpu")  # it loads weights.npz or raises
    assert len(eng.charset) == G.PLACEHOLDER_KEYS + 2
    got, _ = G.serve(OCRWorker(eng, 0))
    check_words(got, assets.load_digits_words()[path])


def write_words() -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        model_dir = assets.make_digits_model_dir(tmp)
        words = {"seed": G.SEED, "scenes": G.N_SCENES,
                 "bundle": {rel: src.name for rel, src in assets.DIGITS_BUNDLE.items()},
                 **{path: jax_words(model_dir, path) for path in PATHS}}
    assets.DIGITS_WORDS.write_text(json.dumps(words, ensure_ascii=False, indent=1) + "\n", encoding="utf-8")
    print(f"wrote {assets.DIGITS_WORDS}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_words()
    else:
        sys.exit("usage: python tests/test_torch_e2e_digits.py --write")
