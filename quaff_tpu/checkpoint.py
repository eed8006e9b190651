"""Training checkpoint/resume.

The reference's only checkpointing is -saveparams rewriting the fitted
parameters each EM iteration (qmodel.cpp:2224-2227); restart loses the
EM iteration count, the convergence baseline and the per-read ref
orderings.  This module checkpoints the full EM state — parameters
(reference-format JSON), iteration number, previous log-likelihood+prior,
and per-read ref sort orders — atomically each iteration, so a preempted
training job resumes with an identical trajectory (the equivalent of
preemption-safe orbax step checkpoints, using the
reference's own human-readable artifact formats).
"""

from __future__ import annotations

import io
import json
import math
import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional

from .model.params import QuaffParams

STATE_FILE = "state.json"
PARAMS_FILE = "params.json"


@dataclass
class TrainState:
    params: QuaffParams
    iteration: int  # number of completed EM iterations
    prev_loglike_with_prior: float
    sort_order: List[List[int]]


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)

    def atomic_write(name: str, text: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(ckpt_dir, name))

    out = io.StringIO()
    state.params.write_json(out)
    atomic_write(PARAMS_FILE, out.getvalue() + "\n")
    atomic_write(
        STATE_FILE,
        json.dumps(
            {
                "iteration": state.iteration,
                "prevLogLikeWithPrior": (
                    None
                    if math.isinf(state.prev_loglike_with_prior)
                    else state.prev_loglike_with_prior
                ),
                "sortOrder": state.sort_order,
            }
        )
        + "\n",
    )


def load_checkpoint(ckpt_dir: str) -> Optional[TrainState]:
    state_path = os.path.join(ckpt_dir, STATE_FILE)
    params_path = os.path.join(ckpt_dir, PARAMS_FILE)
    if not (os.path.exists(state_path) and os.path.exists(params_path)):
        return None
    meta = json.loads(open(state_path).read())
    params = QuaffParams.from_json(open(params_path).read())
    prev = meta.get("prevLogLikeWithPrior")
    return TrainState(
        params=params,
        iteration=int(meta["iteration"]),
        prev_loglike_with_prior=float("-inf") if prev is None else float(prev),
        sort_order=[[int(v) for v in o] for o in meta["sortOrder"]],
    )
