"""The trained-jumbo gate on the port, on the CPU.

The four gates of the JAX package's ``tests/test_e2e_trained_jumbo.py``,
with its bars unchanged, run on the port's ``OCREngine(..., device="cpu")``
over the jumbo bundle (``assets.make_jumbo_model_dir``: the synthetic det
weights, ``weights/rec_scene_jumbo.npz`` and its 5,008-class keys file).
The protocol, the scorer and the bars are ``ppocr_tpu_torch.train.
eval_jumbo``'s:

* staged: ≥ 200 words over 34 scenes of each of three held-out seeds, det
  finds at least ``det_gt − 2 − det_gt // 50`` boxes, ≥ 0.90
  homoglyph-normalized and ≥ 0.62 raw;
* fused (8 boxes, crops at twice the det scale): ≥ 0.90 normalized and
  no more than 2 normalized words below staged on the same scenes;
* a wide banner (drawn here with Pillow at 56 px, as the JAX gate draws
  it) read at similarity ≥ 0.75 through the staged width buckets and the
  fused path's widest tier;
* the staged words of 8 scenes of seed 777 span head indices above 4,000,
  more than 60 distinct (read from the staged run's words: the same
  config on the same scenes gives the same words).

Besides, the first 3 scenes of each seed go through the JAX package's
``OCRWorker`` on the same weights-only bundle (cls off) on both paths, and
the port's words must equal its words: the same count and texts, boxes
within 2 px, confidences within 2e-3 (the bars of the goldens).

``assets/jumbo_banner.npz`` holds the banner's pixels for the smoke run,
which has no Pillow; ``python tests/test_torch_e2e_jumbo.py --write``
rewrites it.
"""

import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import pytest

from ppocr_tpu.pipeline import OCREngine as JaxEngine
from ppocr_tpu.pipeline import OCRWorker as JaxWorker
from ppocr_tpu_torch import assets
from ppocr_tpu_torch.pipeline import OCREngine, OCRWorker
from ppocr_tpu_torch.train import eval_jumbo as G

from test_torch_goldens import few_torch_threads, jax_config  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

PARITY_SCENES = 3  # a seed, through both packages
BOX_TOL = 2
SCORE_TOL = 2e-3


def draw_banner() -> np.ndarray:
    """The JAX gate's banner: ``BANNER_TEXT`` at 56 px in the font its
    renderer picks with seed 0, black on white with a margin, through
    Pillow."""
    from PIL import Image, ImageDraw

    from ppocr_tpu.train.synthetic import PILTextRenderer, jumbo_alphabet

    assert set(G.BANNER_TEXT) <= set(jumbo_alphabet()), "gate text left charset"
    r = PILTextRenderer(sizes=(G.BANNER_SIZE,))
    font = r.pick_font(G.BANNER_TEXT, np.random.default_rng(0))
    dx0, dy0, dx1, dy1 = r.measure(G.BANNER_TEXT, font)
    img = Image.new("RGB", (dx1 - dx0 + 16, dy1 - dy0 + 12), (255, 255, 255))
    ImageDraw.Draw(img).text((8 - dx0, 6 - dy0), G.BANNER_TEXT, font=font, fill=(0, 0, 0))
    return np.asarray(img)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return str(assets.make_jumbo_model_dir(tmp_path_factory.mktemp("trained_jumbo")))


@pytest.fixture(scope="module")
def staged_score(model_dir):
    eng = OCREngine(model_dir, G.gate_config(), device="cpu")
    assert len(eng.charset) > 4500  # the custom keys file is in force
    return G.score(OCRWorker(eng, 0)), eng.charset


@pytest.fixture(scope="module")
def fused_score(model_dir):
    return G.score(OCRWorker(OCREngine(model_dir, G.fused_config(), device="cpu"), 0))


class TestJumboGates:
    def test_staged_pipeline_reads_jumbo_charset(self, staged_score):
        sc, _ = staged_score
        assert sc.total >= G.MIN_TOTAL
        assert sc.det_found >= G.det_floor(sc.det_gt), (sc.det_found, sc.det_gt)
        assert sc.normalized >= G.MIN_STAGED_NORMALIZED, (
            f"{sc.norm_exact}/{sc.total} normalized ({sc.exact} raw); misses: {sc.misses}")
        assert sc.raw >= G.MIN_STAGED_RAW, f"{sc.exact}/{sc.total} raw; misses: {sc.misses}"
        assert G.bar_failures(staged=sc) == []

    def test_fused_pipeline_reads_jumbo_charset(self, staged_score, fused_score):
        staged, fused = staged_score[0], fused_score
        assert fused.total >= G.MIN_TOTAL
        assert fused.det_found >= G.det_floor(fused.det_gt), (fused.det_found, fused.det_gt)
        assert fused.normalized >= G.MIN_FUSED_NORMALIZED, (
            f"{fused.norm_exact}/{fused.total} normalized ({fused.exact} raw); misses: {fused.misses}")
        assert fused.norm_exact >= staged.norm_exact - G.MAX_FUSED_LOSS, (
            f"fused {fused.norm_exact} vs staged {staged.norm_exact} normalized; misses: {fused.misses}")
        assert G.bar_failures(staged, fused) == []

    def test_wide_banner_width_tiers_at_jumbo_scale(self, model_dir):
        banner = draw_banner()
        # crop content ≈ 48·aspect px: above the mult-2 canvas (256 at
        # img_w 128), inside the mult-4 canvas (512): the widest tier
        assert 5.4 < banner.shape[1] / banner.shape[0] < 10.5, banner.shape
        sims = {}
        for fused in (False, True):
            worker = OCRWorker(OCREngine(model_dir, G.banner_config(fused), device="cpu"), 0)
            words = worker.process(banner, 1 + fused)["words"]
            sims[fused] = G.banner_similarity(words), words
        assert sims[False][0] >= G.MIN_BANNER_SIMILARITY, sims[False]
        assert sims[True][0] >= G.MIN_BANNER_SIMILARITY, sims[True]

    def test_head_indices_span_the_full_head(self, staged_score):
        sc, charset = staged_score
        seen = G.head_indices(sc, charset)
        assert max(seen, default=0) > G.MIN_HEAD_MAX_INDEX, sorted(seen)[-5:]
        assert len(seen) > G.MIN_HEAD_DISTINCT, len(seen)
        assert G.head_failures(seen) == []


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_first_scenes_equal_the_jax_package(model_dir, staged_score, fused_score, path):
    cfg = G.gate_config() if path == "staged" else G.fused_config()
    eng = JaxEngine(model_dir, jax_config(dataclasses.asdict(cfg)))
    assert eng.random_weights == {"det": False, "rec": False}
    eng.post.backend = "cv2"
    want = G.score(JaxWorker(eng, 0), n_scenes=PARITY_SCENES)
    got = staged_score[0] if path == "staged" else fused_score
    assert len(want.words) == 3 * PARITY_SCENES
    n_words = 0
    for key, want_words in want.words.items():
        got_words = got.words[key]
        assert [w["text"] for w in got_words] == [w["text"] for w in want_words], key
        for g, w in zip(got_words, want_words):
            assert np.abs(np.asarray(g["box"]) - np.asarray(w["box"])).max() <= BOX_TOL, (key, g, w)
            assert abs(g["confidence"] - w["confidence"]) <= SCORE_TOL, (key, g, w)
        n_words += len(want_words)
    assert n_words >= 15


def test_eval_script_prints_the_jax_scripts_keys(capsys):
    """``scripts/eval_jumbo_torch.py --device cpu`` on 2 scenes a seed:
    one JSON line a path with every key of ``scripts/eval_jumbo.py``'s,
    and exit 0 (the 200-word bar is not applied with ``--scenes``)."""
    import importlib.util
    import json

    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("eval_jumbo_torch", root / "scripts" / "eval_jumbo_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--device", "cpu", "--both", "--scenes", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    keys = {"rec", "path", "raw", "normalized", "exact", "norm_exact", "total", "det_found",
            "det_gt", "misses"}
    assert [x["path"] for x in lines] == ["staged", "fused"]
    for x in lines:
        assert keys <= set(x) and x["total"] >= 6 and x["device"] == "cpu"


def test_committed_banner_is_the_pillow_drawing():
    np.testing.assert_array_equal(assets.load_jumbo_banner(), draw_banner())


def write_banner() -> None:
    np.savez_compressed(assets.JUMBO_BANNER, banner=draw_banner())
    print(f"wrote {assets.JUMBO_BANNER}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_banner()
    else:
        sys.exit("usage: python tests/test_torch_e2e_jumbo.py --write")
