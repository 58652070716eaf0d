"""Training over several cards: the port's mesh train steps on distinct
cards, against the one-device step, on the card's machine.

    python3 scripts/profile_torch_train_devices.py

Runs every mesh the visible cards allow among data 2, data 1 × model 2
(two cards) and data 4, data 2 × model 2 (four cards), for

* **rec**: ``make_train_step`` from the jumbo recognizer on the batch of
  ``scripts/profile_torch_train.py`` (32 crops of 48×320, labels of 1–30
  classes);
* **det**: ``make_det_train_step`` from the trained detector on that
  script's 8 cuts of 512×512 with masks from the golden boxes (data
  meshes only: the detector's model axis carries nothing).

Each mesh is first held to the one-device step on card 0 in f32 with TF32
off (3 steps: losses rtol 1e-5, parameters as ``chip_smoke.adam_close``
states, the rows' copies bit-equal), then timed with cuDNN's default TF32:
3 untimed steps of every configuration, then 20 steps of each between
step ends (CUDA events on card 0; the step returns its loss there, after
its last kernel on every card) in turns, twice; peak memory per card; the
kernel launches per step summed over the cards (``torch.profiler``, two
steps). Prints one JSON object per model with the card's name and power
limit; exits 1 without a card.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from ppocr_tpu_torch import assets  # noqa: E402
from profile_torch_train import det_batch, rec_batch  # noqa: E402
from ppocr_tpu_torch.models import det_to_jax, rec_to_jax  # noqa: E402
from ppocr_tpu_torch.parallel import make_mesh  # noqa: E402
from ppocr_tpu_torch.train import trainer as TT  # noqa: E402
from ppocr_tpu_torch.utils.checkpoint import load_params_npz  # noqa: E402

STEPS, WARM, ROUNDS = 20, 3, 2


def meshes(devices, det: bool) -> dict:
    """name → mesh (None: one device) for the devices there are."""
    out = {"one_device": None}
    n = len(devices)
    for data, model in ((2, 1), (1, 2), (4, 1), (2, 2)):
        if data * model <= n and not (det and model > 1):
            out[f"data{data}" + (f"_model{model}" if model > 1 else "")] = make_mesh(
                devices=devices[: data * model], model=model)
    return out


def run(name, make, params, batch, to_jax, lr, devices) -> dict:
    configs = meshes(devices, det=name == "det")

    def start(m):
        kw = {"device": devices[0]} if configs[m] is None else {"mesh": configs[m]}
        _, init_fn, step_fn = make(learning_rate=lr, **kw)
        return init_fn(params), step_fn

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    trees, losses = {}, {}
    with chip_smoke.f32_exact():
        for m in configs:
            state, step_fn = start(m)
            losses[m] = []
            for _ in range(3):
                state, loss = step_fn(state, batch)
                losses[m].append(float(loss))
            trees[m] = to_jax(state.model)
            if m != "one_device":
                rows = state.model.rows
                if not all(torch.equal(a, b.to(a.device)) for r in rows[1:]
                           for a, b in zip(rows[0].parameters(), r.parameters())):
                    raise AssertionError(f"{name} {m}: the rows' copies differ")
    parity = {}
    for m in list(configs)[1:]:
        for a, b in zip(losses[m], losses["one_device"]):
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"{name} {m} losses {losses[m]} vs {losses['one_device']}")
        worst, off, n = chip_smoke.adam_close(trees[m], trees["one_device"], 3 * lr)
        parity[m] = {"losses": losses[m], "params_max_abs_diff": worst,
                     "params_off_tight": f"{off}/{n}"}

    states = {}
    for m in configs:
        state, step_fn = start(m)
        for _ in range(WARM):
            state, _ = step_fn(state, batch)
        states[m] = [state, step_fn]
    order = list(configs)
    rounds = {m: [] for m in configs}
    peaks = {m: [0] * len(devices) for m in configs}
    for m in (order + order[::-1]) * (ROUNDS // 2):
        state, step_fn = states[m]
        sync()
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        ends = []
        for _ in range(STEPS + 1):
            state, loss = step_fn(state, batch)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()  # on card 0, where the loss is formed after every card's work
            ends.append(ev)
        sync()
        rounds[m].append(statistics.median(a.elapsed_time(b) for a, b in zip(ends, ends[1:])))
        peaks[m] = [max(p, torch.cuda.max_memory_allocated(d)) for p, d in zip(peaks[m], devices)]
        states[m][0] = state
    timed = {}
    for m in configs:
        state, step_fn = states[m]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                state, loss = step_fn(state, batch)
            sync()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and not e.key.startswith("Optimizer.")]
        mesh = configs[m]
        timed[m] = {"devices": [str(d) for d in (mesh.devices if mesh else devices[:1])],
                    "step_ms": statistics.median(rounds[m]), "step_ms_by_round": rounds[m],
                    "max_memory_allocated_gb_by_card": [p / 1e9 for p in peaks[m]],
                    "launches_per_step": sum(e.count for e in kernels) / 2}
    del states, state
    base = timed["one_device"]
    for m in list(configs)[1:]:
        timed[m]["step_ms_ratio"] = timed[m]["step_ms"] / base["step_ms"]
    return {"model": name, "parity_f32_tf32_off_vs_one_device": parity, "timed": timed,
            "card": chip_smoke.card_line(), "cards": len(devices)}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_train_devices: no CUDA device available", file=sys.stderr)
        return 1
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rng = np.random.default_rng(0)
    runs = (
        ("rec", TT.make_train_step, load_params_npz(str(assets.WEIGHTS / "rec_scene_jumbo.npz")),
         rec_batch(rng), rec_to_jax, 1e-4),
        ("det", TT.make_det_train_step,
         load_params_npz(str(assets.WEIGHTS / "det_synthetic_text.npz")), det_batch(rng),
         det_to_jax, 1e-3),
    )
    for name, make, params, batch, to_jax, lr in runs:
        print(json.dumps(run(name, make, params, batch, to_jax, lr, devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
