#!/usr/bin/env python3
"""Run msst_tpu's and the port's multi-session drive (``multisession_drive``)
on the CPU, aligned and without the align, and print each package's result
dict as one JSON line per run.

    python3 scripts/torch_vs_ref_multisession.py [--profile drive|bench]
        [--slots 8] [--scans 56] [--control-scans N] [--warm 24]
        [--align-every 6] [--seed 0] [--packages msst_tpu,msst_torch]
        [--threads N] [--check-aligns] [--no-control] [--perturb FEED]

Profiles:

* ``drive``: ``drive_params()``, 16 x 360 (msst_tpu's validated drive
  profile; tests/test_parallel.py's drive and chip_smoke.py phase 14a).
* ``bench``: bench.py's profile (``bench.py:237-243``): ``LioParams``
  defaults at 16 x 1800, ``max_points`` 28,864, 256 keyframes, loop closure
  off, driven at 1800 columns (chip_smoke.py phase 14b).

msst_tpu runs over ``--slots`` virtual CPU devices.  Its
``batched_odometry_step`` reads an undefined name (``inp``) in
``odometry_core``; as tests/test_torch_multisession_step.py does, the
script replaces it, in this process only, by a jitted ``vmap`` of
msst_tpu's step that binds the name to the prepared scan while it traces,
and edits nothing of msst_tpu.  ``--control-scans`` drives the control
(no align) over fewer scans.  Each JSON line: package, profile, aligned,
scans, seconds, and the drive's result dict.  Runs on the CPU: the bench
profile takes msst_tpu ~10-20 min.

``--perturb FEED`` scales every point of session j by 1 + 2^-23 N(0, 1)
(chip_smoke.py's ``_perturbed`` under the seed [FEED, j]): a
rounding-level change of the feed, the same in both packages, as
chip_smoke.py phase 14b drives it on the card.

``--check-aligns`` (with msst_tpu) also takes each state that msst_tpu's
aligned drive hands to its ``cross_session_align`` through the port's
align, and prints one JSON line per align: whether ``found`` and
``candidate_session`` are equal, and the largest gaps of the anchors and
of the corrected keyframe positions and poses: the packages' agreement
on the drive's own states, without the drive's amplification.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile_params(ms, params, profile: str):
    """(LioParams, horizon) of a profile, from a package's multisession
    and params modules."""
    if profile == "drive":
        return ms.drive_params(), 360
    return params.LioParams(n_scan=16, horizon_scan=1800,
                            max_points=16 * 1800 + 64,
                            loop_closure_enabled=False,
                            max_keyframes=256), 1800


def check_aligns(records, args) -> None:
    """Each recorded msst_tpu align (its input state, diagnostics and output
    state, numpy) through the port's align, one JSON line each."""
    import numpy as np

    from msst_torch import convert
    from msst_torch.models.liosam import params
    from msst_torch.parallel import make_mesh
    from msst_torch.parallel import multisession as tms

    p, _ = _profile_params(tms, params, args.profile)
    mesh = make_mesh(args.slots, device="cpu")
    for scan, st, diag, new in records:
        tst = convert.from_numpy(st, "cpu")
        tst = tst._replace(local_map=tst.local_map._replace(
            corner_grid=None, surf_grid=None))
        got_st, got = tms.cross_session_align(tst, p, mesh)
        valid = (np.arange(st.kf.pose6.shape[1])[None]
                 < st.kf.count[:, None])
        print(json.dumps({
            "align": scan,
            "found": np.asarray(diag["found"]).astype(int).tolist(),
            "found_equal": bool(np.array_equal(got["found"].numpy(),
                                               diag["found"])),
            "candidates_equal": bool(np.array_equal(
                got["candidate_session"].numpy(), diag["candidate_session"])),
            "anchor_gap": float(np.abs(got["anchor_pose6"].numpy()
                                       - diag["anchor_pose6"]).max()),
            "kf_position_gap_m": float(np.abs(
                got_st.kf.pose6.numpy()[..., 3:] - new.kf.pose6[..., 3:]
            )[valid].max()),
            "pose_gap_m": float(np.abs(got_st.pose6.numpy()[:, 3:]
                                       - new.pose6[:, 3:]).max()),
        }), flush=True)


def run_msst_tpu(args, aligned: bool, n_scans: int) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from msst_tpu.models.liosam import mapping, params
    from msst_tpu.parallel import make_mesh
    from msst_tpu.parallel import multisession as ms

    def bound(state, inp, p):
        ps = mapping.prepare_scan(inp, p)
        mapping.inp = ps
        try:
            return mapping.odometry_core(state, ps, p)
        finally:
            del mapping.inp

    @functools.partial(jax.jit, static_argnames=("p",))
    def step(states, inputs, p):
        new, outs = jax.vmap(lambda s, i: bound(s, i, p))(states, inputs)
        return new, outs, {
            "total_keyframes": jnp.sum(outs.kf_count),
            "degenerate_sessions": jnp.sum(outs.degenerate.astype(jnp.int32)),
            "mean_speed": jnp.mean(jnp.linalg.norm(outs.velocity, axis=-1))}

    def strong(tree):
        return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)

    ms.batched_odometry_step = (lambda states, inputs, p, mesh,
                                axis="session": step(strong(states), inputs,
                                                     p))
    ms.make_batched_state = jax.jit(ms.make_batched_state,
                                    static_argnums=(0, 1))
    records = []
    align = ms.cross_session_align

    def recording_align(states, p, mesh, axis="session", n_cand=2):
        new, diag = align(states, p, mesh, axis, n_cand)
        if args.check_aligns:
            np_ = functools.partial(jax.tree.map, np.asarray)
            records.append((len(records), np_(states), np_(diag), np_(new)))
        return new, diag

    ms.cross_session_align = recording_align
    p, horizon = _profile_params(ms, params, args.profile)
    try:
        res = ms.multisession_drive(p, make_mesh(args.slots), n_scans=n_scans,
                                    n_warm=args.warm,
                                    align_every=args.align_every,
                                    horizon=horizon, use_align=aligned,
                                    seed=args.seed)
    finally:
        ms.cross_session_align = align
    if records:
        check_aligns(records, args)
    return res


def run_msst_torch(args, aligned: bool, n_scans: int) -> dict:
    import torch

    from msst_torch.models.liosam import params
    from msst_torch.parallel import make_mesh
    from msst_torch.parallel import multisession as ms

    if args.threads:
        torch.set_num_threads(args.threads)
    p, horizon = _profile_params(ms, params, args.profile)
    return ms.multisession_drive(p, make_mesh(args.slots, device="cpu"),
                                 n_scans=n_scans, n_warm=args.warm,
                                 align_every=args.align_every,
                                 horizon=horizon, use_align=aligned,
                                 seed=args.seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", choices=("drive", "bench"), default="drive")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--scans", type=int, default=56)
    ap.add_argument("--control-scans", type=int, default=None)
    ap.add_argument("--warm", type=int, default=24)
    ap.add_argument("--align-every", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0,
                    help="the drive's seed (its simulator noise and offsets)")
    ap.add_argument("--packages", default="msst_tpu,msst_torch")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--check-aligns", action="store_true")
    ap.add_argument("--no-control", action="store_true",
                    help="drive the aligned run only")
    ap.add_argument("--perturb", type=int, default=None, metavar="FEED",
                    help="drive rounding-level perturbed feeds")
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += f" --xla_force_host_platform_device_count={args.slots}"
    # at the bench profile one virtual device's align outlasts the CPU
    # collectives' 40 s rendezvous timeout, which ends the process
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_collective_call_terminate_timeout_seconds=36000"
        " --xla_cpu_collective_timeout_seconds=36000"
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=3600").strip()
    sys.path.insert(0, REPO)
    packages = args.packages.split(",")
    if "msst_tpu" in packages:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import contextlib
    import importlib

    import chip_smoke

    runs = {"msst_tpu": run_msst_tpu, "msst_torch": run_msst_torch}
    for name in packages:
        sim = importlib.import_module(f"{name}.utils.sim")
        for aligned in (True,) if args.no_control else (True, False):
            n = args.scans if aligned else (args.control_scans or args.scans)
            t0 = time.perf_counter()
            with (contextlib.nullcontext() if args.perturb is None else
                  chip_smoke._ms_perturbed(sim, args.perturb)):
                res = runs[name](args, aligned, n)
            print(json.dumps({"package": name, "profile": args.profile,
                              "aligned": aligned, "scans": n,
                              "seed": args.seed, "perturb": args.perturb,
                              "seconds": round(time.perf_counter() - t0, 1),
                              "slots": args.slots, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
