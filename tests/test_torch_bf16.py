"""The port's bf16 recognizer against the JAX package's bf16 recognizer.

bf16 is the dtype every request is served in (``PipelineConfig.dtype``,
``service_main --dtype``). The jumbo bundle's recognizer
(``weights/rec_scene_jumbo.npz``, 5,008 classes) runs on the golden
words of the committed scenes (the parity and serving scenes' golden
boxes, bounding-cropped, ``crnn_resize``d to 48 px at the two width tiers
the fused path picks for this bundle: 256 and 128), normalized in f32 and
then cast, with the weights cast as ``cast_tree(params, jnp.bfloat16)``
casts them and as the port's engine casts its module (``.to(bf16)``).

Measured on these 33 crops: the two bf16 forwards pick different argmax
classes at 3 of 1,056 frames at width 256 and 2 of 528 at width 128, in
2 crops at each width. The f32 top-2 gaps at those frames are 0.0056,
0.0120 and 0.0165 at width 256 and 0.0013 and 0.0034 at width 128. The
JAX package's bf16 forward deviates from its f32 forward by a p99
(over the frames, of each frame's max-abs deviation) of 0.0196 at width
256 and 0.0326 at width 128; the port's p99 is 0.0142 and 0.0335.

The bar, and why: two bf16 forwards round at different places (XLA and
PyTorch keep different intermediates in bf16), so where the f32 forward's
top two classes are closer than bf16 moves a probability, either may win.
How far bf16 moves a probability on these inputs is read from the JAX
package alone, so the port's own error earns it no room: the resolution
of a tier is the p99 of the JAX bf16 forward's deviation from f32 over
all its frames. A frame where the two argmaxes differ is bf16 precision
when its f32 top-2 gap is within that resolution. Every differing frame
must be such a frame, they must stay under 1 % of the frames, and the
decoded texts must agree on every crop that has none. The port's bf16
must also not drift further from f32 than the JAX package's: its p99
deviation within 1.5× of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppocr_tpu.models import cast_tree
from ppocr_tpu.models.rec_svtr import rec_forward as jax_rec_forward
from ppocr_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ppocr_tpu_torch.assets import WEIGHTS, load_goldens, load_scenes
from ppocr_tpu_torch.models.jax_params import rec_from_jax
from ppocr_tpu_torch.models.rec_svtr import rec_forward
from ppocr_tpu_torch.ops.ctc import ctc_greedy_decode_np
from ppocr_tpu_torch.ops.geometry import bounding_crop
from ppocr_tpu_torch.ops.resize import crnn_resize

from test_torch_goldens import few_torch_threads  # noqa: F401  (autouse)

TIERS = (256, 128)  # the jumbo bundle's rec width 256 and its half (fused_width_mult 2)
MAX_SHARE = 0.01  # differing frames, of all frames


@pytest.fixture(scope="module")
def golden_crops():
    scenes, goldens = load_scenes(), load_goldens()
    crops, texts = [], []
    for config, images in (("small", scenes["parity"]), ("serving", scenes["serving"])):
        for img, words in zip(images, goldens["words"][config]):
            for w in words:
                crops.append(bounding_crop(img, w["box"]))
                texts.append(w["text"])
    return crops, texts


@pytest.fixture(scope="module")
def forwards():
    tree = jax_load_npz(str(WEIGHTS / "rec_scene_jumbo.npz"))
    keys = [line.rstrip("\r\n") for line in open(WEIGHTS / "jumbo_keys.txt", encoding="utf-8")
            if line.rstrip("\r\n")]
    charset = ["blank"] + keys + [" "]
    model = rec_from_jax(tree).to(torch.bfloat16).eval()
    jax_fwd = jax.jit(jax_rec_forward)
    half = cast_tree(tree, jnp.bfloat16)

    def run(x):
        with torch.no_grad():
            port = rec_forward(model, torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        want = np.asarray(jax_fwd(half, jnp.asarray(x, jnp.bfloat16)), np.float32)
        full = np.asarray(jax_fwd(tree, jnp.asarray(x)))
        return port, want, full

    return run, charset


@pytest.mark.parametrize("width", TIERS)
def test_bf16_rec_argmax_matches_jax_bf16(golden_crops, forwards, width):
    crops, _ = golden_crops
    run, charset = forwards
    x = np.stack([crnn_resize(c, width / 48, (3, 48, width)) for c in crops]).astype(np.float32)
    x = (x / 255.0 - 0.5) * 2.0
    port, want, full = run(x)
    assert port.shape == want.shape == (len(crops), width // 8, len(charset))
    assert np.isfinite(port).all()

    differ = port.argmax(-1) != want.argmax(-1)
    top2 = np.sort(full, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    dev_port = np.abs(port - full).max(-1)
    dev_jax = np.abs(want - full).max(-1)
    resolution = np.percentile(dev_jax, 99)  # the reference's alone
    precision = differ & (gap <= resolution)
    print(f"width {width}: {int(differ.sum())} of {differ.size} frames differ, "
          f"{int(precision.sum())} of them within bf16 precision ({resolution:.4f}; gaps "
          f"{[round(float(g), 4) for g in gap[differ]]}); p99 deviation from f32 "
          f"port {np.percentile(dev_port, 99):.4f}, jax {resolution:.4f}")
    assert not (differ & ~precision).any(), (
        f"argmax differs beyond bf16 precision at {np.argwhere(differ & ~precision).tolist()}")
    assert differ.sum() <= MAX_SHARE * differ.size
    assert np.percentile(dev_port, 99) <= 1.5 * np.percentile(dev_jax, 99)

    got_texts, _ = ctc_greedy_decode_np(port, charset)
    want_texts, _ = ctc_greedy_decode_np(want, charset)
    for i, (g, w) in enumerate(zip(got_texts, want_texts)):
        if not precision[i].any():
            assert g == w, (i, g, w)
