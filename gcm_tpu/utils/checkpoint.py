"""Checkpoint / resume of simulation state (SURVEY.md §5).

The reference has no restartable checkpointing (VTK snapshots are
output-only); this framework checkpoints the full state pytree — fields,
fracture bond masks, corrector aux, step counter — so long runs survive
preemption. Each checkpoint is one ``step_<N>.npz`` (leaves keyed by their
pytree path), written to a temporary name and moved into place with
``os.replace``, so a checkpoint either exists whole or not at all. The
three newest are kept.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import numpy as np

MAX_TO_KEEP = 3


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.npz")


def _steps(directory: str, prefix: str):
    out = []
    for f in glob.glob(os.path.join(directory, f"{prefix}_*.npz")):
        m = re.fullmatch(rf"{prefix}_(\d+)\.npz", os.path.basename(f))
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    # must end in .npz or np.savez appends the suffix itself
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _flatten(tree) -> Dict[str, np.ndarray]:
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def save_checkpoint(directory: str, step: int, state: Dict[str, Any]) -> None:
    """Save ``state`` (an arbitrary pytree of arrays) at ``step``.

    A top-level ``"traces"`` entry (the accumulated detector record) is
    stored as a ``traces_<N>.npz`` sidecar: its leading dimension grows
    with the step, so a fresh engine's restore template cannot know it."""
    traces = None
    has_traces = isinstance(state, dict) and "traces" in state
    if has_traces:
        state = dict(state)
        traces = state.pop("traces")
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    if has_traces:
        # sidecar FIRST: a completed step file must imply its sidecar
        # exists, or a preemption between the two would resume with the
        # pre-resume seismogram silently dropped
        if isinstance(traces, dict):
            # multi-body record: one array per body
            arrays = {f"body:{k}": np.asarray(v) for k, v in traces.items()}
        else:
            arrays = {"traces": np.asarray(traces)}
        _atomic_savez(os.path.join(directory, f"traces_{step}.npz"), arrays)
    _atomic_savez(_step_path(directory, step), _flatten(state))
    # rotation: the newest MAX_TO_KEEP steps, sidecars with them (they
    # grow with the step — unbounded retention is O(T^2) disk)
    keep = set(_steps(directory, "step")[-MAX_TO_KEEP:])
    for prefix in ("step", "traces"):
        for s in _steps(directory, prefix):
            if s not in keep:
                try:
                    os.unlink(os.path.join(directory, f"{prefix}_{s}.npz"))
                except OSError:
                    pass


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory), "step") \
        if os.path.isdir(directory) else []
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, state_like: Dict[str, Any],
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Restore the pytree saved at ``step`` (default: latest), shaped like
    the template ``state_like``."""
    import jax

    directory = os.path.abspath(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    wants_traces = isinstance(state_like, dict) and "traces" in state_like
    if wants_traces:
        state_like = {k: v for k, v in state_like.items() if k != "traces"}
    with np.load(_step_path(directory, step)) as z:
        saved = {k: z[k] for k in z.files}
    if (isinstance(state_like, dict) and "points_md5" in state_like
            and not any(k.startswith("['points_md5']") for k in saved)):
        # checkpoints written without the node-numbering fingerprint:
        # restore without it — the engine then skips the check
        state_like = {k: v for k, v in state_like.items()
                      if k != "points_md5"}
    paths, treedef = jax.tree_util.tree_flatten_with_path(state_like)
    leaves = []
    for p, _ in paths:
        key = jax.tree_util.keystr(p)
        if key not in saved:
            raise ValueError(f"checkpoint step {step} under {directory} "
                             f"has no entry {key}")
        leaves.append(saved[key])
    out = jax.tree_util.tree_unflatten(treedef, leaves)
    sidecar = os.path.join(directory, f"traces_{step}.npz")
    # only attach when the caller's template asked for traces — a stale
    # sidecar from another run sharing the directory must not leak into
    # a detector-free restore
    if wants_traces and isinstance(out, dict) and os.path.exists(sidecar):
        out = dict(out)
        try:
            with np.load(sidecar) as z:
                if "traces" in z.files:
                    out["traces"] = z["traces"]
                else:
                    out["traces"] = {k.split(":", 1)[1]: z[k]
                                     for k in z.files
                                     if k.startswith("body:")}
        except Exception as e:
            raise ValueError(
                f"corrupt detector-trace sidecar {sidecar}: {e}; delete "
                "it to resume without the pre-resume seismogram") from e
    return out
