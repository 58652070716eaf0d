"""The multi-device dry run: one step of each trainer over a mesh.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: the recognizer's CTC step over an ``n_devices``
mesh (data parallel, and tensor parallel over a "model" axis of 2 where n
is even), then the detector's balanced-BCE step over the same devices,
data parallel, each on tiny inputs, with the same inits, batches and
rates. It prints the JAX function's line,

    dryrun_multichip ok: mesh={'data': 4, 'model': 2}, ctc loss=65.0417, det bce loss=0.6932; serving equality: ...

and returns its numbers. The JAX function's serving part (mesh serving
against one device) runs on the reference's paddle models, which the port
does not load (ROADMAP A9), so it is always skipped here; the port's mesh
serving is held by its tests and by ``chip_smoke.py``'s "devices" phase.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

SERVING_SKIPPED = "serving equality: skipped (the port does not load the reference's paddle models)"


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """One rec and one det train step over ``n_devices`` of ``devices``
    (default: the visible cards; a device may repeat, as in ``["cpu"] *
    8``). Raises ``RuntimeError`` when there are fewer than
    ``n_devices``. Returns {mesh, ctc_loss, det_bce_loss, serving}."""
    from ..models import init_det_params, init_rec_params
    from ..train import make_det_train_step, make_train_step
    from .mesh import make_mesh

    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = list(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]

    # a model axis of 2 runs tensor parallelism where the mesh allows it
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(devices=devices, model=model_axis)
    _, init_fn, step_fn = make_train_step(learning_rate=1e-4, mesh=mesh)
    state = init_fn(init_rec_params(seed=0))
    n = n_devices  # one example per device
    batch = {
        "images": np.zeros((n, 48, 64, 3), np.float32),
        "labels": np.tile(np.array([[5, 9, 0, 0]], np.int32), (n, 1)),
        "label_paddings": np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32), (n, 1)),
    }
    state, loss = step_fn(state, batch)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite CTC loss {loss}")
    if state.step != 1:
        raise AssertionError(f"rec step count {state.step}")

    dmesh = make_mesh(devices=devices, model=1)
    _, dinit_fn, dstep_fn = make_det_train_step(learning_rate=1e-3, mesh=dmesh)
    dstate = dinit_fn(init_det_params(seed=0))
    dbatch = {"images": np.zeros((n, 64, 64, 3), np.float32),
              "masks": np.zeros((n, 64, 64), np.float32)}
    dstate, dloss = dstep_fn(dstate, dbatch)
    dloss = float(dloss)
    if not math.isfinite(dloss):
        raise AssertionError(f"non-finite det BCE loss {dloss}")
    if dstate.step != 1:
        raise AssertionError(f"det step count {dstate.step}")

    print(f"dryrun_multichip ok: mesh={mesh.shape}, ctc loss={loss:.4f}, "
          f"det bce loss={dloss:.4f}; {SERVING_SKIPPED}")
    return {"mesh": mesh.shape, "ctc_loss": loss, "det_bce_loss": dloss,
            "serving": SERVING_SKIPPED}
