"""Multi-body engine: several Tasks coupled by contact interfaces.

Counterpart of the reference Engine's multi-mesh mode
(SURVEY.md §3.1): all bodies share one jitted step (a dict pytree), the
contact/fracture state (per-interface bond masks) is part of the scan carry,
so fracture evolution runs entirely on device.
"""

from __future__ import annotations

import dataclasses
import time as _time
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gcm_tpu.engine import RunResult
from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.solver.contact import ContactSpec
from gcm_tpu.solver.multi import step_multi
from gcm_tpu.task import Task


@dataclasses.dataclass
class MultiRunResult:
    bodies: Dict[str, np.ndarray]
    bonded: Dict[int, np.ndarray]
    t: float
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float
    traces: Optional[Dict[str, np.ndarray]] = None  # body -> [steps, np, nc]


class MultiBodyEngine:
    """Bodies: {name: Task}; contacts couple named bodies' faces.

    All bodies must use the same model, order and symmetrization; dt is the
    global CFL minimum over bodies (as in the reference's allreduce-min,
    SURVEY.md §3.1 — but static, computed once host-side).

    Paths: without a mesh, every sweep solves borders and contacts in
    place (solver.multi.step_multi). With ``mesh=`` the sweeps run under
    shard_map with explicit halo exchange (parallel.halo) and borders and
    contacts become exact post-sweep slab fixups (step_multi_fast). The
    opt-in canonical layout runs each body's whole step and then fixes the
    contact face rows (step_multi_fused).
    """

    def __init__(self, bodies: Dict[str, Task], contacts: Sequence[ContactSpec],
                 dtype=jnp.float32, mesh=None, canonical_layout: bool = False):
        names = list(bodies)
        self.tasks = bodies
        self.contacts = tuple(contacts)
        t0 = bodies[names[0]]
        self.model = get_model(t0.model)
        self.order = t0.order
        self.symmetrize = t0.symmetrize_stages
        self.mesh = mesh
        for t in bodies.values():
            if t.model != t0.model or t.order != t0.order:
                raise ValueError("bodies must share model and order")

        self.mats: Dict[str, MaterialFields] = {}
        self.us: Dict[str, jnp.ndarray] = {}
        self.hs: Dict[str, Tuple[float, ...]] = {}
        self.borders = {}
        dts = []
        for name, task in bodies.items():
            mat = task.material_fields(xp=jnp, dtype=dtype)
            self.mats[name] = mat
            self.hs[name] = task.grid.h
            self.borders[name] = dict(task.borders)
            from gcm_tpu.task import apply_initial

            u0 = np.zeros((self.model.ncomp,) + task.grid.shape)
            apply_initial(u0, self.model, task.grid, task.initial)
            self.us[name] = jnp.asarray(u0, dtype=dtype)
            dts.append(task.time.cfl * min(task.grid.h) / mat.max_cp())
        self.dt = float(min(dts))
        self.nsteps = t0.time.steps_for(self.dt)

        # Canonical permuted layout (OPT-IN): when every contact shares one
        # axis, the engine stores state with that axis FIRST and steps with
        # the permuted model (models.spec.permuted_model), so the contact
        # face-slab fixups are leading-axis slabs.
        # NOTE: the dimensional-splitting order becomes (ca, rest) and its
        # reverse — an equally valid second-order symmetrized pair, but a
        # numerically DIFFERENT splitting than the default (x,y,z)/(z,y,x)
        # — hence opt-in (canonical_layout=True). Verified exact against
        # the jnp step_multi run with the matching axis order
        # (tests/test_multibody_fast.py). Inputs/outputs stay in task
        # layout: state_dict, run results and snapshots unpermute at the
        # boundary.
        self._perm = None
        orig_contacts = self.contacts   # task-layout axes, pre-permutation
        contact_axes = {c.axis for c in self.contacts}
        # conformity must be evaluated with the ORIGINAL contact axes on
        # the task-layout grids, BEFORE any canonical permutation: the
        # permuted axis would make faces_conform compare the wrong
        # transverse extents and build_interface_maps treat the wrong
        # axis as the interface normal. Non-conforming interfaces also
        # disqualify the canonical perm entirely (the full-step composition
        # can't serve them, and the in-stage maps are built in task layout).
        from gcm_tpu.solver.contact_nc import faces_conform as _conform
        from gcm_tpu.solver.multi import fused_contacts_ok

        all_conforming = all(
            c.span is not None
            or _conform(bodies[c.body_a].grid, bodies[c.body_b].grid,
                        c.axis)
            for c in self.contacts)
        perm = None
        remesh = None
        iso = all(isinstance(m, MaterialFields) for m in self.mats.values())
        if (canonical_layout and all_conforming and iso
                and self.model.dim == 3 and len(contact_axes) == 1):
            ca = next(iter(contact_axes))
            rest = [d for d in range(3) if d != ca]
            if mesh is None:
                if ca != 0:
                    perm = (ca,) + tuple(rest)
            elif len(mesh.axis_names) == 1 and ca != 0:
                # canonical UNDER a device mesh: the contact axis LEADS
                # (whole on every shard — fixups stay thin slabs), the
                # mesh's one axis shards the MIDDLE spatial axis (rebuilt
                # as a ('sy',)-mesh so the halo step's axis naming lines
                # up), and the last axis stays unsharded. The transverse
                # storage order must stay TASK-ASCENDING (rest[0],
                # rest[1]): ContactSpec lo/span entries map to the
                # remaining storage dims in ascending order
                # (contact.face_sub_index), and checkpointed fracture bond
                # masks are saved in the permuted transverse layout.
                nsh = int(mesh.devices.size)
                if all(t.grid.shape[rest[0]] % nsh == 0
                       for t in bodies.values()):
                    perm = (ca,) + tuple(rest)
                    from jax.sharding import Mesh as _Mesh

                    remesh = _Mesh(
                        np.asarray(mesh.devices).reshape(-1), ("sy",))
            if perm is not None:
                pshapes = {k: tuple(t.grid.shape[p] for p in perm)
                           for k, t in bodies.items()}
                pcontacts = tuple(dataclasses.replace(c, axis=0)
                                  for c in self.contacts)
                if not fused_contacts_ok(self.model, pshapes, pcontacts,
                                         self.order):
                    perm = remesh = None
            if perm is not None:
                if remesh is not None:
                    mesh = remesh
                    self.mesh = mesh
                self._perm = perm
                from gcm_tpu.models.spec import permuted_model

                self.model = permuted_model(self.model, perm)
                up = (0,) + tuple(1 + p for p in perm)
                self.us = {k: jnp.transpose(v, up)
                           for k, v in self.us.items()}
                self.mats = {k: jax.tree.map(
                                 lambda x: jnp.transpose(x, perm), v)
                             for k, v in self.mats.items()}
                self.hs = {k: tuple(h[p] for p in perm)
                           for k, h in self.hs.items()}
                self.borders = {
                    k: {(perm.index(f[0]), f[1]): b for f, b in bd.items()}
                    for k, bd in self.borders.items()}
                self.contacts = tuple(
                    dataclasses.replace(c, axis=0) for c in self.contacts)

        if mesh is not None and mesh.devices.size > 1:
            # (1-device meshes keep the state unsharded — see Engine)
            from gcm_tpu.parallel.sharding import (
                field_sharding, material_sharding)

            fs = field_sharding(mesh, self.model.dim)
            ms = material_sharding(mesh, self.model.dim)
            self.us = {k: jax.device_put(v, fs) for k, v in self.us.items()}
            self.mats = {
                k: jax.tree.map(partial(jax.device_put, device=ms), v)
                for k, v in self.mats.items()}

        # sharded per-sweep path: raw shard_map sweeps, borders/contacts as
        # post-fixups (the halo stage names the leading spatial axis 'sx')
        self._raw_stage = None
        if (mesh is not None and self._perm is None
                and "sx" in mesh.axis_names):
            from gcm_tpu.parallel.halo import (
                extend_mats_once, make_spmd_raw_stage)

            fns = {
                name: make_spmd_raw_stage(
                    self.model, mesh, self.dt, self.hs[name], self.order)
                for name in names
            }
            # one-time per-axis material extension per body
            prepared = {
                name: extend_mats_once(self.mats[name], mesh,
                                       self.model.dim, self.order)
                for name in names
            }

            def _raw(name, u, axis):
                return fns[name](u, prepared[name], axis)

            self._raw_stage = _raw

        # non-conforming interfaces: bodies whose face grids do not share
        # collocated nodes get static interpolation maps built once here
        # (VERDICT r2 missing #4); explicit lo/span stays on the collocated
        # offset path
        from gcm_tpu.solver.contact_nc import (
            build_interface_maps, faces_conform)

        # NOTE: conformity and interface maps use the ORIGINAL (task-
        # layout) contact axes — self.contacts may already carry permuted
        # axes, but the grids here are task-layout GridSpecs (code-review
        # r5). The canonical perm is gated on all-conforming above, so
        # when it engaged this loop builds nothing.
        self.ncmaps: Dict[int, object] = {}
        for ci, c in enumerate(orig_contacts):
            ga, gb = bodies[c.body_a].grid, bodies[c.body_b].grid
            if c.span is None and not faces_conform(ga, gb, c.axis):
                self.ncmaps[ci] = build_interface_maps(ga, gb, c.axis)
        assert not (self._perm is not None and self.ncmaps), \
            "canonical layout must not engage with non-conforming contacts"

        # full-step composition of the canonical layout: each body runs its
        # whole step (non-contact borders in place, raw edge clamp at
        # full-contact faces), then the contact face rows are recomputed
        # (solver.multi.step_multi_fused)
        self._full_step = None
        self._mexts = None
        if self._perm is not None:
            full_faces = set()
            for c in self.contacts:
                if c.span is None:
                    full_faces.add((c.body_a, c.axis, 1))
                    full_faces.add((c.body_b, c.axis, 0))
            body_bcs = {
                name: {f: b for f, b in self.borders[name].items()
                       if (name,) + f not in full_faces}
                for name in names}
            if mesh is None:
                from gcm_tpu.solver.gcm import step as jnp_step

                def _full(name, u, axes, mat, mext):
                    return jnp_step(self.model, u, mat, self.dt,
                                    self.hs[name], self.order,
                                    body_bcs[name], axes)
            else:
                from gcm_tpu.parallel.halo import (
                    extend_mats_once, make_spmd_step)

                spmd_steps = {
                    name: make_spmd_step(self.model, mesh, self.dt,
                                         self.hs[name], self.order,
                                         body_bcs[name])
                    for name in names}
                self._mexts = {
                    name: extend_mats_once(self.mats[name], mesh,
                                           self.model.dim, self.order)
                    for name in names}

                def _full(name, u, axes, mat, mext):
                    return spmd_steps[name](u, mext, axes)

            self._full_step = _full

        # bond masks for fracture-enabled contacts (overlap slab shape;
        # non-conforming contacts carry per-side masks)
        self.bonded: Dict[int, jnp.ndarray] = {}
        for ci, c in enumerate(self.contacts):
            if c.tensile_strength is not None:
                if ci in self.ncmaps:
                    from gcm_tpu.solver.contact_nc import init_bonded_nc

                    self.bonded[ci] = init_bonded_nc(self.ncmaps[ci], dtype)
                elif c.span is not None:
                    self.bonded[ci] = jnp.ones(tuple(c.span), dtype=dtype)
                else:
                    shape_a = self._pshape(c.body_a)
                    slab = tuple(s for a, s in enumerate(shape_a)
                                 if a != c.axis)
                    self.bonded[ci] = jnp.ones(slab, dtype=dtype)

        # detectors (per body)
        self._det_idx: Dict[str, np.ndarray] = {}
        for name, task in bodies.items():
            if task.detectors is not None:
                pts = [self._pnode(task.grid.index_of(p))
                       for p in task.detectors.points]
                self._det_idx[name] = np.asarray(pts, dtype=np.int32)

        # ODE corrector aux state per body (VERDICT r2 missing #2: a
        # viscoelastic/damage multi-body run must not silently compute pure
        # elasticity) — applied after contact correction, as in the
        # reference's engine loop (SURVEY.md §3.1)
        self.auxs: Dict[str, Dict] = {}
        for name, task in bodies.items():
            aux: Dict = {}
            for corr in task.correctors:
                aux.update(corr.init_aux(self.model, self._pshape(name)))
            self.auxs[name] = aux

        # sources (per body) — amplitudes for all steps in one vectorized call
        self._srcs = []
        times = (np.arange(self.nsteps, dtype=np.float64) + 1.0) * self.dt
        for name, task in bodies.items():
            for src in task.sources:
                node = self._pnode(task.grid.index_of(src.position))
                for cname in src.components:
                    # broadcast scalar-returning wavelets (code-review r5)
                    amps = np.broadcast_to(
                        np.asarray(src.wavelet(times), np.float64),
                        times.shape) * self.dt
                    self._srcs.append((name, node, self.model.comp(cname),
                                       jnp.asarray(amps, dtype=dtype)))

    # ---------------- permuted-layout helpers (identity when _perm is None)

    def _pshape(self, name: str):
        shape = self.tasks[name].grid.shape
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
        inv = tuple(self._perm.index(d) for d in range(3))
        return jnp.transpose(u, (0,) + tuple(1 + p for p in inv))

    def _permute_u(self, u):
        if self._perm is None:
            return u
        return jnp.transpose(u, (0,) + tuple(1 + p for p in self._perm))

    def _unpermute_s(self, x):
        """Spatial-only arrays (corrector aux fields)."""
        if self._perm is None:
            return x
        inv = tuple(self._perm.index(d) for d in range(3))
        return jnp.transpose(x, inv)

    def _permute_s(self, x):
        if self._perm is None:
            return x
        return jnp.transpose(x, self._perm)

    # ----------------------------------------------------------- checkpoint

    def _assemble_traces(self) -> Optional[Dict[str, np.ndarray]]:
        """Per-body concatenation of the accumulated trace chunks (the
        full record, including restored pre-resume chunks)."""
        if not self._det_idx:
            return None
        chunks = getattr(self, "_trace_chunks", [])
        out = {}
        for k in self._det_idx:
            parts = [c[k] for c in chunks if k in c]
            out[k] = (np.concatenate(parts, axis=0) if parts else
                      np.zeros((0, len(self._det_idx[k]),
                                self.model.ncomp)))
        return out

    def state_dict(self) -> Dict:
        """Restartable state: per-body fields, fracture bond masks,
        corrector aux (e.g. damage), steps completed. Bond masks matter —
        resuming without them would silently heal every crack (VERDICT r1).
        Detector traces ride along (utils.checkpoint stores them as an
        npz sidecar) so resumed seismograms stay complete."""
        d = {"us": {k: self._unpermute_u(v) for k, v in self.us.items()},
             "bonded": {str(k): v for k, v in self.bonded.items()},
             "aux": {k: {ak: self._unpermute_s(av)
                         for ak, av in a.items()}
                     for k, a in self.auxs.items()},
             "step": getattr(self, "_done_step", 0)}
        tr = self._assemble_traces()
        if tr is not None:
            d["traces"] = tr
        return d

    def load_state(self, state: Dict) -> None:
        tr = state.get("traces")
        self._trace_chunks = (
            [{k: np.asarray(v) for k, v in tr.items()}]
            if isinstance(tr, dict) and any(
                np.size(v) for v in tr.values()) else [])
        self.us = {k: self._permute_u(jnp.asarray(v))
                   for k, v in state["us"].items()}
        # non-conforming contacts store per-side mask dicts, so tree-map
        self.bonded = {int(k): jax.tree.map(jnp.asarray, v)
                       for k, v in state["bonded"].items()}
        if "aux" in state:
            self.auxs = {k: {ak: self._permute_s(jnp.asarray(av))
                             for ak, av in a.items()}
                         for k, a in dict(state["aux"]).items()}
        self.start_step = int(np.asarray(state["step"]))
        # odd (period-misaligned) checkpoints are fine: run() realigns with
        # single forward steps, like every other engine (VERDICT r3 weak #6)

    def _step_params(self):
        """Material state threaded through jit boundaries as ARGUMENTS
        (closure-captured arrays serialize into the program)."""
        return {"mats": self.mats, "mexts": self._mexts}

    def _one_step(self, us, bonded, auxs, n_amp, parity: int, params=None):
        if params is None:
            params = self._step_params()
        axes = tuple(range(self.model.dim))
        if self.symmetrize and parity == 1:
            axes = axes[::-1]
        if self._full_step is not None:
            from gcm_tpu.solver.multi import step_multi_fused

            mats, mexts = params["mats"], params["mexts"]

            def body(name, u, axes_):
                return self._full_step(
                    name, u, axes_, mats[name],
                    None if mexts is None else mexts[name])

            us, bonded = step_multi_fused(
                self.model, us, mats, self.dt, self.hs,
                self.order, self.borders, self.contacts, bonded,
                body, axes,
            )
        elif self._raw_stage is not None:
            from gcm_tpu.solver.multi import step_multi_fast

            us, bonded = step_multi_fast(
                self.model, us, params["mats"], self.borders, self.contacts,
                bonded, self._raw_stage, axes, self.ncmaps,
            )
        else:
            us, bonded = step_multi(
                self.model, us, params["mats"], self.dt, self.hs,
                self.order, self.borders, self.contacts, bonded, axes,
                self.ncmaps,
            )
        for k, (name, node, comp, _) in enumerate(self._srcs):
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(n_amp[k])
        new_auxs = {}
        for name, task in self.tasks.items():
            u, aux = us[name], auxs[name]
            for corr in task.correctors:
                u, aux = corr(self.model, u, aux, self.dt)
            if task.correctors:
                us = dict(us)
                us[name] = u
            new_auxs[name] = aux
        return us, bonded, new_auxs

    def run(self, snapshot_cb=None, snapshot_every: int = 0
            ) -> MultiRunResult:
        """Run all remaining steps; optionally call
        ``snapshot_cb(step, {name: np.ndarray})`` every ``snapshot_every``
        steps (host-side, outside jit) — the reference engine's per-mesh
        snapshot cadence (SURVEY.md §3.1) on the multi-body engine.

        The cadence is rounded UP to a multiple of the symmetrization
        period (2 when ``symmetrize``): snapshots can only fire between
        jitted scan chunks, which always cover whole periods (advisor r3:
        ``snapshot_every=5`` snapshots every 6 steps, never every 4)."""
        period = 2 if self.symmetrize else 1
        nsteps = self.nsteps
        start = int(getattr(self, "start_step", 0))
        nrun = nsteps - start
        # full symmetrization periods run inside the jitted scan; a leading
        # realignment head (period-misaligned resume) and a trailing odd
        # step run as single forward steps, matching Engine/SimplexEngine
        # (VERDICT r2 weak #3 / r3 weak #6)
        nhead = min(max(nrun, 0), (period - start % period) % period)
        nfull = ((nrun - nhead) // period) * period
        amps_all = (
            jnp.stack([a[start:nsteps] for _, _, _, a in self._srcs], 1)
            if self._srcs else jnp.zeros((max(nrun, 0), 0), dtype=jnp.float32)
        )
        nsrc = amps_all.shape[1]

        def detect(us):
            # one vectorized gather per body (VERDICT r2 weak #7)
            out = {}
            for name, idx in self._det_idx.items():
                sel = tuple(idx[:, a] for a in range(self.model.dim))
                out[name] = us[name][(slice(None),) + sel].T
            return out

        def body(carry, x, params):
            us, bonded, auxs = carry
            trs = []
            for p in range(period):
                us, bonded, auxs = self._one_step(us, bonded, auxs, x[p],
                                                  p, params)
                trs.append(detect(us))
            stacked = {k: jnp.stack([t[k] for t in trs]) for k in trs[0]} \
                if self._det_idx else {}
            return (us, bonded, auxs), stacked

        # materials as jit ARGS, not closure constants (see _step_params);
        # the jitted scan is CACHED on the engine — a fresh jax.jit
        # wrapper per run() call would retrace+recompile the whole step
        # program every time (code-review r5)
        scan_all = getattr(self, "_scan_all", None)
        if scan_all is None:
            @partial(jax.jit, donate_argnums=0)
            def scan_all(carry, amps, params):
                return jax.lax.scan(lambda c, x: body(c, x, params),
                                    carry, amps)

            self._scan_all = scan_all

        chunk = snapshot_every if (snapshot_cb and snapshot_every) else nfull
        chunk = max(period, -(-max(chunk, period) // period) * period)

        t0 = _time.perf_counter()
        us, bonded, auxs = self.us, self.bonded, self.auxs

        def _norm(tr):
            # normalized per-chunk record {body: [steps, np, ncomp]}
            return {k: np.asarray(v).reshape(
                        -1, len(self._det_idx[k]), self.model.ncomp)
                    for k, v in tr.items()}

        if start == 0:
            self._trace_chunks = []
        # chunks live on the engine: checkpointed (state_dict) so a
        # resumed run's seismogram covers the FULL record (code-review r5)
        chunks = self._trace_chunks = list(
            getattr(self, "_trace_chunks", []))
        for n in range(start, start + nhead):
            us, bonded, auxs = self._one_step(
                us, bonded, auxs, amps_all[n - start], n % period)
            if self._det_idx:
                chunks.append(_norm(detect(us)))
            self.us, self.bonded, self.auxs = us, bonded, auxs
            self._done_step = n + 1
        done = 0
        while done < nfull:
            # land on global chunk multiples even when a resume starts
            # mid-grid, so exact step%cadence checks in callbacks hit
            take = min(chunk - (start + nhead + done) % chunk,
                       nfull - done) // period
            amps = amps_all[nhead + done:nhead + done + take * period].reshape(
                take, period, nsrc)
            (us, bonded, auxs), tr = scan_all((us, bonded, auxs), amps,
                                              self._step_params())
            if self._det_idx:
                chunks.append(_norm(tr))
            done += take * period
            self.us, self.bonded, self.auxs = us, bonded, auxs
            self._done_step = start + nhead + done
            if snapshot_cb is not None:
                snapshot_cb(start + nhead + done,
                            {k: np.asarray(jax.device_get(
                                 self._unpermute_u(v)))
                             for k, v in us.items()})
        for n in range(start + nhead + nfull, nsteps):
            us, bonded, auxs = self._one_step(
                us, bonded, auxs, amps_all[n - start], n % period)
            if self._det_idx:
                chunks.append(_norm(detect(us)))
        jax.tree.map(lambda a: a.block_until_ready(), us)
        wall = _time.perf_counter() - t0
        npts = sum(int(np.prod(t.grid.shape)) for t in self.tasks.values())
        self.us, self.bonded, self.auxs = us, bonded, auxs
        self._done_step = nsteps
        trace_out = self._assemble_traces()
        return MultiRunResult(
            bodies={k: np.asarray(jax.device_get(self._unpermute_u(v)))
                    for k, v in us.items()},
            bonded={k: jax.tree.map(lambda a: np.asarray(jax.device_get(a)), v)
                    for k, v in bonded.items()},
            t=nsteps * self.dt,
            nsteps=nsteps,
            dt=self.dt,
            wall_seconds=wall,
            points_per_second=npts * nrun / max(wall, 1e-12),
            traces=trace_out,
        )

    def write_snapshots(self, outdir: str, tag: str = "final") -> None:
        """Per-body VTK snapshots + the interface bond masks as .npy."""
        import os

        from gcm_tpu.snapshot.vtk import snapshot_fields, write_vti

        os.makedirs(outdir, exist_ok=True)
        for name, task in self.tasks.items():
            u = np.asarray(jax.device_get(self._unpermute_u(self.us[name])))
            write_vti(
                os.path.join(outdir, f"{name}_{tag}.vti"),
                task.grid.shape, task.grid.h, task.grid.origin,
                snapshot_fields(self.model, u),
            )
        for ci, mask in self.bonded.items():
            if isinstance(mask, dict):   # non-conforming: per-side masks
                for side, m in mask.items():
                    np.save(
                        os.path.join(
                            outdir, f"contact{ci}_bonded_{side}_{tag}.npy"),
                        np.asarray(jax.device_get(m)))
            else:
                np.save(os.path.join(outdir, f"contact{ci}_bonded_{tag}.npy"),
                        np.asarray(jax.device_get(mask)))
