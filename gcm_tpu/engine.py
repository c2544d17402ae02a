"""Engine: builds a Task into device state and runs the time loop.

Counterpart of the reference's ``Engine`` (SURVEY.md §2 component
13, §3.1): owns the mesh state, computes the (static) CFL dt, sequences the
splitting stages, injects sources, records detector traces and snapshots.

Differences from the reference, by design (SURVEY.md §7):
- dt is computed once host-side (materials are static) — no per-step
  allreduce / device sync;
- the inner loop is a ``lax.scan`` over steps (pairs of steps when the stage
  order is symmetrized), jit-compiled once with donated state;
- detector traces are accumulated on device as scan outputs (one gather per
  step), fetched at the end — not a host readback per step;
- snapshots cut the scan into chunks at the snapshot cadence.
"""

from __future__ import annotations

import dataclasses
import time as _time
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import Model, get_model
from gcm_tpu.solver.gcm import cfl_dt, step as solver_step
from gcm_tpu.task import Task
from gcm_tpu.utils.backend import compute_device


def select_kernel(task: Task, model: Model, mat, dtype, mesh=None,
                  perm=None) -> str:
    """The compute path for ``task``: ``Task.kernel="jnp"`` pins the XLA
    sweeps; ``"auto"`` takes the one-pass Hopper step kernel
    (ops.hopper_step) when compute lands on a Hopper GPU, there is no
    device mesh and the task qualifies, and the jnp path otherwise."""
    if task.kernel == "jnp":
        return "jnp"
    from gcm_tpu.ops.hopper_step import eligible

    if eligible(model, mat, task.order, dtype, task.borders,
                compute_device(mesh), mesh=mesh, perm=perm):
        return "hopper"
    return "jnp"


@dataclasses.dataclass
class RunResult:
    u: np.ndarray                       # final state [ncomp, *spatial]
    t: float                            # final time
    nsteps: int
    dt: float
    traces: Optional[np.ndarray]        # [nsteps, npoints, ncomp] or None
    wall_seconds: float
    points_per_second: float
    kernel: str = "jnp"                 # compute path that ran


class Engine:
    """Single-body engine. Multi-body + contact lives in engine_multi.

    Distribution:
    - ``mesh=`` (a ``jax.sharding.Mesh`` over ('sx'[, 'sy'])) runs each
      step under shard_map: every shard sweeps its block extended by a
      halo fetched with ``ppermute`` (gcm_tpu.parallel.halo);
    - ``sharding=`` (a NamedSharding) runs the global jnp program under
      GSPMD, which derives the halo collectives itself.
    """

    def __init__(self, task: Task, sharding=None, mesh=None,
                 dtype=jnp.float32):
        self.task = task
        self.model: Model = get_model(task.model)
        if self.model.dim != task.grid.dim:
            raise ValueError("model dim != grid dim")
        self.dtype = dtype

        self.mat = task.material_fields(xp=jnp, dtype=dtype)
        self.dt = cfl_dt(self.mat, task.grid.h, task.time.cfl)
        self.nsteps = task.time.steps_for(self.dt)

        from gcm_tpu.task import apply_initial

        u0 = np.zeros((self.model.ncomp,) + task.grid.shape, dtype=np.float64)
        apply_initial(u0, self.model, task.grid, task.initial)
        self.u = jnp.asarray(u0, dtype=dtype)

        # Canonical permuted layout (opt-in, Task.canonical_layout): store
        # state with a 128-aligned axis last. Physics follows storage —
        # the splitting order becomes the permuted axis sequence and its
        # reverse, an equally valid symmetrized pair (mirrors
        # MultiBodyEngine's canonical mode). All inputs/outputs stay in
        # task layout.
        self._perm = None
        self._h = task.grid.h
        self._borders = dict(task.borders)
        # isotropic only: with OrthotropicMaterialFields the ortho stack's
        # axis-keyed fields (OrthoKeys.pair/zero) would read the PERMUTED
        # sweep axis as a physical axis — silently wrong stiffness lookups
        if (getattr(task, "canonical_layout", False)
                and mesh is None and sharding is None
                and self.model.dim in (2, 3)
                and isinstance(self.mat, MaterialFields)):
            dim = self.model.dim
            shape = task.grid.shape
            aligned = [j for j in range(dim) if shape[j] % 128 == 0]
            perm = None
            if shape[-1] % 128 != 0 and aligned:
                j = aligned[-1]
                perm = tuple(d for d in range(dim) if d != j) + (j,)
            if perm is not None:
                self._perm = perm
                from gcm_tpu.models.spec import permuted_model

                self.model = permuted_model(self.model, perm)
                self.u = jnp.transpose(self.u,
                                       (0,) + tuple(1 + p for p in perm))
                self.mat = jax.tree.map(
                    lambda x: jnp.transpose(x, perm), self.mat)
                self._h = tuple(task.grid.h[p] for p in perm)
                self._borders = {(perm.index(f[0]), f[1]): b
                                 for f, b in task.borders.items()}

        self.mesh = mesh
        self._spmd_step = None      # shard_map halo step (mesh path)
        self._mext = None           # halo-extended materials (mesh path)
        if mesh is not None and sharding is not None:
            raise ValueError("pass either mesh= or sharding=, not both")
        if mesh is not None:
            from gcm_tpu.parallel.halo import extend_mats_once, make_spmd_step
            from gcm_tpu.parallel.sharding import (
                field_sharding, material_sharding)

            mshard = material_sharding(mesh, self.model.dim)
            self.u = jax.device_put(self.u,
                                    field_sharding(mesh, self.model.dim))
            self.mat = jax.tree.map(
                partial(jax.device_put, device=mshard), self.mat)
            # static materials: one-time per-axis halo extension, so the
            # per-step exchange moves only the state
            self._mext = extend_mats_once(
                self.mat, mesh, self.model.dim, task.order)
            self._spmd_step = make_spmd_step(
                self.model, mesh, self.dt, task.grid.h, task.order,
                task.borders)
        elif sharding is not None:
            self.u = jax.device_put(self.u, sharding)
            self.mat = jax.tree.map(partial(jax.device_put, device=sharding), self.mat)

        #: compute path that ran: "hopper" (one-pass CUDA step kernel) or
        #: "jnp" (XLA sweeps, the semantics of record)
        self.kernel = "jnp" if sharding is not None else select_kernel(
            task, self.model, self.mat, dtype, mesh=mesh, perm=self._perm)

        # source injection tables: static node indices + per-step amplitudes
        # (all steps evaluated in one vectorized call — setup stays O(1)-ish
        # even for nsteps ~ 1e6)
        self._src_idx: List[Tuple[Tuple[int, ...], int]] = []
        amps = []
        times = (np.arange(self.nsteps, dtype=np.float64) + 1.0) * self.dt
        for src in task.sources:
            node = self._pnode(task.grid.index_of(src.position))
            for cname in src.components:
                self._src_idx.append((node, self.model.comp(cname)))
                # scalar-returning wavelet fns (constant sources) must
                # broadcast like the simplex engines do (code-review r5)
                amps.append(np.broadcast_to(
                    np.asarray(src.wavelet(times), np.float64),
                    times.shape) * self.dt)
        self._src_amps = (
            jnp.asarray(np.asarray(amps, dtype=np.float64).T, dtype=dtype)
            if amps else jnp.zeros((self.nsteps, 0), dtype=dtype)
        )

        # detector gather indices
        self._det_idx: Optional[np.ndarray] = None
        if task.detectors is not None:
            pts = [self._pnode(task.grid.index_of(p))
                   for p in task.detectors.points]
            self._det_idx = np.asarray(pts, dtype=np.int32)  # [np, dim]

        # corrector aux state (e.g. damage fields) — part of the checkpoint
        self.aux: Dict = {}
        for corr in task.correctors:
            self.aux.update(corr.init_aux(self.model, self._pshape()))
        #: first step index run() will execute (set by load_state on resume)
        self.start_step: int = 0
        self._done_step: int = 0
        #: detector-trace chunks accumulated so far (checkpointed, so a
        #: resumed run's seismogram covers the FULL record — code-review
        #: r5: resume used to silently overwrite the seismogram files
        #: with only the post-resume steps)
        self._trace_chunks: List[np.ndarray] = []

        self._scan_fn = None

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """Full restartable state: fields, corrector aux, completed steps
        (always in TASK layout, independent of canonical storage)."""
        d = {"u": self._unpermute_u(self.u),
             "aux": {k: self._unpermute_s(v)
                     for k, v in self.aux.items()},
             "step": self._done_step}
        if self._det_idx is not None:
            tr = self._assemble_traces()
            d["traces"] = tr if tr is not None else np.zeros(
                (0, len(self._det_idx), self.model.ncomp), np.float32)
        return d

    def load_state(self, state: Dict) -> None:
        """Restore a ``state_dict`` checkpoint; ``run()`` then executes only
        the remaining ``nsteps - step`` steps (resume == uninterrupted,
        tests/test_io.py)."""
        self.u = self._permute_u(jnp.asarray(state["u"], dtype=self.dtype))
        self.aux = {k: self._permute_s(jnp.asarray(v))
                    for k, v in dict(state["aux"]).items()}
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        tr = state.get("traces")
        self._trace_chunks = (
            [np.asarray(tr)] if tr is not None and np.size(tr) else [])

    # -------------------------------------------------- layout helpers

    def _pshape(self):
        shape = self.task.grid.shape
        if self._perm is None:
            return shape
        return tuple(shape[p] for p in self._perm)

    def _pnode(self, node):
        if self._perm is None:
            return tuple(node)
        return tuple(node[p] for p in self._perm)

    def _unpermute_u(self, u):
        if self._perm is None:
            return u
        inv = tuple(self._perm.index(d) for d in range(len(self._perm)))
        return jnp.transpose(u, (0,) + tuple(1 + p for p in inv))

    def _permute_u(self, u):
        if self._perm is None:
            return u
        return jnp.transpose(u, (0,) + tuple(1 + p for p in self._perm))

    def _unpermute_s(self, x):
        if self._perm is None:
            return x
        inv = tuple(self._perm.index(d) for d in range(len(self._perm)))
        return jnp.transpose(x, inv)

    def _permute_s(self, x):
        if self._perm is None:
            return x
        return jnp.transpose(x, self._perm)

    # ------------------------------------------------------------------ step

    def _step_params(self):
        """Material state threaded through jit boundaries as ARGUMENTS.
        Closure-captured material arrays are serialized INTO the program,
        which bloats every compile; passing them as args makes them plain
        runtime parameters."""
        return {"mext": self._mext, "mat": self.mat}

    def _one_step(self, u, aux, src_amp, step_parity: int, params=None):
        task, model = self.task, self.model
        if params is None:
            params = self._step_params()
        axes = tuple(range(model.dim))
        if task.symmetrize_stages and step_parity == 1:
            axes = axes[::-1]
        if self._spmd_step is not None:
            u = self._spmd_step(u, params["mext"], axes)
        elif self.kernel == "hopper":
            from gcm_tpu.ops.hopper_step import hopper_step

            u = hopper_step(u, params["mat"], self.dt, self._h,
                            self._borders, axes)
        else:
            u = solver_step(
                model, u, params["mat"], self.dt, self._h, task.order,
                self._borders, axes,
            )
        for k, (node, comp) in enumerate(self._src_idx):
            u = u.at[(comp,) + node].add(src_amp[k])
        for corr in task.correctors:
            u, aux = corr(model, u, aux, self.dt)
        return u, aux

    def _detect(self, u):
        # one vectorized gather for all receivers — a realistic survey line
        # (hundreds of points) must not bloat the jaxpr with per-point
        # gathers (VERDICT r2 weak #7)
        if self._det_idx is None:
            return jnp.zeros((0, self.model.ncomp), dtype=u.dtype)
        idx = tuple(self._det_idx[:, a] for a in range(self.model.dim))
        return u[(slice(None),) + idx].T  # [npoints, ncomp]

    def _build_scan(self):
        period = 2 if self.task.symmetrize_stages else 1

        def body(carry, x, params):
            u, aux = carry
            amps = x  # [period, nsrc]
            trs = []
            for p in range(period):
                u, aux = self._one_step(u, aux, amps[p], p, params)
                trs.append(self._detect(u))
            return (u, aux), jnp.stack(trs)  # [period, npoints, ncomp]

        unroll = max(1, int(getattr(self.task, "scan_unroll", 1)))

        # materials enter as jit ARGS, not closure constants (see
        # _step_params — closure constants serialize into the program)
        @partial(jax.jit, donate_argnums=0)
        def scan_steps(carry, amps_chunk, params):
            return jax.lax.scan(lambda c, x: body(c, x, params),
                                carry, amps_chunk, unroll=unroll)

        return scan_steps, period

    def _assemble_traces(self) -> Optional[np.ndarray]:
        """Concatenate the accumulated detector-trace chunks (full record,
        including restored pre-resume chunks) or None without detectors."""
        if self._det_idx is None or not self._trace_chunks:
            return None
        ncomp = self.model.ncomp
        return np.concatenate(
            [np.asarray(t).reshape(-1, len(self._det_idx), ncomp)
             for t in self._trace_chunks], axis=0)

    # ------------------------------------------------------------------ run

    def run(self, snapshot_cb: Optional[Callable[[int, np.ndarray], None]] = None,
            cb_every: Optional[int] = None) -> RunResult:
        """Run the remaining steps (``start_step`` .. ``nsteps``); optionally
        call ``snapshot_cb(step, u)`` at the task's snapshot cadence
        (host-side, outside jit). ``cb_every`` overrides the cadence —
        run_with_outputs uses it to interleave snapshot AND checkpoint
        cadences (code-review r5: checkpoints used to exist only inside
        the snapshot callback)."""
        if self._scan_fn is None:
            # cache across run() calls: a fresh jax.jit wrapper per call
            # would retrace+recompile the whole step program every time
            # (code-review r5)
            self._scan_fn = self._build_scan()
        scan_steps, period = self._scan_fn
        nsteps = self.nsteps
        start = int(self.start_step)
        every = cb_every if cb_every is not None \
            else self.task.snapshots.every
        nsrc = self._src_amps.shape[1]

        u = self.u
        aux = self.aux
        if start == 0:
            self._trace_chunks = []      # fresh run: discard stale chunks
        # alias: appends are visible to state_dict() from checkpoint
        # callbacks mid-run, and a resumed run extends the restored record
        traces = self._trace_chunks = list(self._trace_chunks)
        t0 = _time.perf_counter()
        done = start

        def single(n):
            nonlocal u, aux
            u, aux = self._one_step(u, aux, self._src_amps[n], n % period)
            traces.append(self._detect(u)[None])

        # align a resumed run to a symmetrization-period boundary, so the
        # jitted scan always starts at even parity (resume == uninterrupted)
        while done < nsteps and done % period != 0:
            single(done)
            done += 1
        nfull_end = done + ((nsteps - done) // period) * period
        chunk = every if (snapshot_cb and every) else max(nfull_end - done, period)
        # round UP to the symmetrization period (the documented cadence
        # convention — every=5 fires every 6 steps, never every 4; the
        # multi-body engines already did this, code-review r5)
        chunk = max(period, -(-chunk // period) * period)
        while done < nfull_end:
            # land on multiples of ``chunk`` even when a resume starts
            # mid-grid, so the callback's exact step%cadence checks hit
            take = min(chunk - done % chunk, nfull_end - done) // period
            amps_chunk = self._src_amps[done:done + take * period].reshape(
                take, period, nsrc)
            (u, aux), tr = scan_steps((u, aux), amps_chunk,
                                      self._step_params())
            traces.append(tr)
            done += take * period
            # keep current for checkpointing callbacks
            self.u, self.aux, self._done_step = u, aux, done
            if snapshot_cb is not None:
                snapshot_cb(done, np.asarray(jax.device_get(
                    self._unpermute_u(u))))
        # tail steps that don't fill a full symmetrization period
        while done < nsteps:
            single(done)
            done += 1
        u.block_until_ready()
        self.aux = aux
        self._done_step = done
        wall = _time.perf_counter() - t0

        npts = int(np.prod(self.task.grid.shape))
        trace_arr = self._assemble_traces()
        self._last_traces = trace_arr
        self.u = u
        return RunResult(
            u=np.asarray(jax.device_get(self._unpermute_u(u))),
            t=nsteps * self.dt,
            nsteps=nsteps,
            dt=self.dt,
            traces=trace_arr,
            wall_seconds=wall,
            points_per_second=npts * (nsteps - start) / max(wall, 1e-12),
            kernel=self.kernel,
        )

    # ------------------------------------------------------------- outputs

    def run_with_outputs(self, outdir: str,
                         checkpoint_every: int = 0) -> RunResult:
        """Run with artifact outputs: VTK snapshots at the task's cadence,
        seismograms at the end, optional checkpoints."""
        import os

        from gcm_tpu.snapshot.seismo import save_seismograms
        from gcm_tpu.snapshot.vtk import snapshot_fields, write_vti

        import math

        os.makedirs(outdir, exist_ok=True)
        task = self.task
        snapdir = os.path.join(outdir, task.snapshots.directory)

        # snapshot and checkpoint cadences are INDEPENDENT (code-review
        # r5: checkpoints used to fire only from inside the snapshot
        # callback — disabled snapshots silently disabled checkpointing).
        # Both are rounded UP to the symmetrization period (the engines'
        # documented cadence convention), the callback fires at their
        # gcd, and each artifact keeps its own exact cadence check.
        period = 2 if task.symmetrize_stages else 1
        rnd = lambda c: -(-c // period) * period if c else 0
        snap_every = rnd(task.snapshots.every)
        ck_every = rnd(checkpoint_every)
        cadences = [c for c in (snap_every, ck_every) if c]

        series = []
        if snap_every:
            os.makedirs(snapdir, exist_ok=True)

        def _snapshot(step: int, u: np.ndarray) -> None:
            fields = snapshot_fields(self.model, u)
            if task.snapshots.fields:
                keep = set(task.snapshots.fields) | {"velocity"}
                fields = {k: v for k, v in fields.items() if k in keep}
            fname = f"{task.name}_{step:06d}.vti"
            write_vti(
                os.path.join(snapdir, fname),
                task.grid.shape, task.grid.h, task.grid.origin, fields,
            )
            series.append((step * self.dt, fname))

        cb = None
        if cadences:
            def cb(step: int, u: np.ndarray) -> None:
                if snap_every and step % snap_every == 0:
                    _snapshot(step, u)
                if ck_every and step % ck_every == 0:
                    from gcm_tpu.utils.checkpoint import save_checkpoint

                    save_checkpoint(
                        os.path.join(outdir, "checkpoints"), step,
                        self.state_dict(),
                    )

        res = self.run(snapshot_cb=cb,
                       cb_every=math.gcd(*cadences) if cadences else None)
        if series:
            from gcm_tpu.snapshot.vtk import write_pvd

            # ParaView collection: animate the series over physical time
            write_pvd(os.path.join(snapdir, f"{task.name}.pvd"), series)
        if res.traces is not None and task.detectors is not None:
            save_seismograms(
                outdir, task.name, res.traces, self.dt,
                task.detectors.points, self.model.comp_names,
            )
        return res
