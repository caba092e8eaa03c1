"""Multi-pod dry-run of the port on the meta device; the port of
``repro/launch/dryrun.py``.

Every (arch x shape x mesh) case (``launch/specs.py``) runs its step once
on meta tensors, one DiPaCo worker a rank, under a fake process group of
as many ranks as the mesh has workers (``comm_analysis.fake_world``).
``torch.utils.flop_counter.FlopCounterMode`` counts the step's FLOPs
through the plain versions of the kernels (``kernels/ops.py`` sends meta
tensors there; the step runs ``attn_impl="pallas"``, the path the card
runs), and the collectives it calls are recorded.  Beside them it
records the analytic FLOP and byte model (``launch/flopmodel.py``), the
bytes a device from the shapes and the specs, and an H100 roofline.

The logical meshes are the reference's: 16x16 single-pod, 2x16x16
two-pod, and ``(256/tp, tp)``.  They are shapes only; nothing runs on
them.  The dry-run allocates nothing, so it takes no ``device=``: the
one stated exception to the port's device rule.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.comm_analysis import (collective_stats, fake_world,
                                              link_bytes_per_s,
                                              record_collectives,
                                              roofline_terms)
from repro_torch.launch.flopmodel import analyze as flop_analyze
from repro_torch.launch.mesh import (LogicalMesh, make_production_mesh,
                                     worker_axes)
from repro_torch.launch.sharding import device_bytes
from repro_torch.models import params as P
from repro_torch.models.config import INPUT_SHAPES


def _supports(cfg, shape) -> tuple:
    """long_500k needs sub-quadratic attention: SSM and hybrid configs
    run it natively, the attention configs through a sliding window, so
    no case is skipped."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        return True, "sliding_window"
    return True, ""


def opt_transform(cfg):
    """Beyond-paper optimized variant:
      - causal chunk skipping (structural S^2/2 attention FLOPs),
      - island-internal data parallelism for small-d paths (the DiPaCo
        regime: a path fits an island; tensor-parallel activation
        collectives are the wrong trade below d_model ~ 2048),
      - dots-saveable remat (skip recomputing matmuls),
      - the cross K/V cache for an encoder-decoder, else the int8 KV
        cache.
    The one-hot capacity MoE dispatch stays: scatter dispatch forces a
    sharded compiler into replicated-buffer all-reduces.
    """
    kw = dict(causal_skip=True, remat_policy="dots")
    if cfg.d_model <= 2048 and cfg.arch_type != "ssm":
        kw["island_parallelism"] = "data"
    if cfg.encoder is not None:
        kw["cross_kv_cache"] = True
    else:
        kw["kv_quant"] = True
    return cfg.replace(**kw)


def count_step(case) -> tuple:
    """Run ``case``'s step once on rank 0's meta arguments under a fake
    world of one rank a worker: -> (FLOPs of the rank's step, collective
    records)."""
    ranks = case.static["workers"]
    with fake_world(ranks), record_collectives() as records:
        args = case.local_args(ranks)
        with FlopCounterMode(display=False) as counter:
            out = case.fn(*args)
            if hasattr(out, "wait"):      # the outer step's gathers
                out.wait()
    return counter.get_total_flops(), records


def memory_bytes(case, mesh) -> dict:
    """Bytes a device of each argument group ("params", "optimizer",
    "cache", "inputs"): ``per_device`` laid out by the specs over the
    logical mesh, ``per_rank`` as the port holds them (its rows of every
    worker-stacked leaf, whole)."""
    ranks = case.static["workers"]
    out = {"per_device": {}, "per_rank": {}}
    for name, arg, axes, specs in zip(case.names, case.args, case.axes,
                                      case.specs):
        group = name if name in ("params", "optimizer", "cache") \
            else "inputs"
        dev = rank = 0.0
        for x, ax, spec in zip(P.tree_leaves(arg), P.tree_leaves(axes),
                               P.tree_leaves(specs)):
            n = x.numel() * x.element_size()
            dev += device_bytes(tuple(x.shape), x.element_size(), spec, mesh)
            rank += n / ranks if ax and ax[0] == P.WORKER else n
        for key, v in (("per_device", dev), ("per_rank", rank)):
            out[key][group] = out[key].get(group, 0.0) + v
    for key in ("per_device", "per_rank"):
        out[key]["total"] = sum(out[key].values())
    return out


def run_case(arch: str, shape_name: str, *, multi_pod: bool,
             with_outer: bool = False, verbose: bool = True,
             variant: str = "base", tp: int | None = None) -> dict:
    cfg = get_config(arch)
    if variant == "opt":
        cfg = opt_transform(cfg)
    shape = INPUT_SHAPES[shape_name]
    ok, note = _supports(cfg, shape)
    if tp is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        # sharding-scheme search: the same 256 devices, narrower islands
        assert not multi_pod
        mesh = LogicalMesh(("data", "model"), (256 // tp, tp))
        mesh_name = f"{256 // tp}x{tp}"
    chips = mesh.size
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        cfg = cfg.replace(sliding_window=shape.window)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_name, "note": note, "attn_impl": "pallas"}
    t0 = time.time()
    try:
        case = SP.build_case(cfg.replace(attn_impl="pallas"), shape, mesh)
        flops_rank, records = count_step(case)
        coll = collective_stats(records)
        ranks = case.static["workers"]
        rep = flop_analyze(cfg, shape, num_workers=ranks)
        rec.update({
            "ok": True,
            "workers": ranks,
            "trace_s": round(time.time() - t0, 1),
            # counted through the plain versions on meta tensors: every
            # rank runs the same step on its own rows
            "counted_flops_per_rank": float(flops_rank),
            "counted_flops": float(flops_rank) * ranks,
            # analytic whole-step numbers used for the roofline
            "total_flops": rep.total_flops,
            "total_bytes": rep.hbm_bytes,
            "fwd_flops": rep.fwd_flops,
            "flop_breakdown": rep.breakdown,
            "collectives": coll,
            "memory": memory_bytes(case, mesh),
        })
        rl = roofline_terms(
            total_flops=rec["total_flops"], total_bytes=rec["total_bytes"],
            collective_bytes_per_device=coll["total_bytes"], chips=chips,
            link_bytes_per_s=link_bytes_per_s(mesh, worker_axes(mesh)))
        rec["roofline"] = rl
        rec["model_flops"] = SP.model_flops(cfg, shape)
        rec["useful_flops_ratio"] = (
            rec["model_flops"] / rec["total_flops"]
            if rec["total_flops"] else 0.0)
        if with_outer and shape.kind == "train":
            rec["outer"] = run_outer(cfg, shape, mesh)
        if verbose:
            rl_s = {k: (f"{v:.4f}" if isinstance(v, float) else v)
                    for k, v in rl.items()}
            ratio = rec["counted_flops"] / rec["total_flops"]
            print(f"[OK] {rec['arch']}:{shape_name}:{rec['mesh']} "
                  f"trace={rec['trace_s']}s roofline={rl_s} "
                  f"useful={rec['useful_flops_ratio']:.3f} "
                  f"counted/analytic={ratio:.3f}")
    except Exception as e:  # noqa: BLE001 — record dry-run bugs, don't die
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:],
                    "trace_s": round(time.time() - t0, 1)})
        if verbose:
            print(f"[FAIL] {arch}:{shape_name}:{rec['mesh']}: {rec['error']}")
    return rec


def run_outer(cfg, shape, mesh) -> dict:
    """The fragment reduce of one DiLoCo outer step across the workers:
    its counted FLOPs a rank, its collectives and their time."""
    case = SP.build_outer_case(cfg, shape, mesh)
    flops, records = count_step(case)
    coll = collective_stats(records)
    return {"counted_flops_per_rank": float(flops), "collectives": coll,
            "collective_s": coll["total_bytes"] / link_bytes_per_s(
                mesh, worker_axes(mesh))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--with-outer", action="store_true")
    ap.add_argument("--variant", choices=["base", "opt"], default="base")
    ap.add_argument("--tp", type=int, default=None,
                    help="island TP width (single-pod mesh reshape)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_case(arch, shape, multi_pod=mp,
                               with_outer=args.with_outer,
                               variant=args.variant, tp=args.tp)
                records.append(rec)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(records, f, indent=1)
    n_ok = sum(r["ok"] for r in records)
    print(f"\n{n_ok}/{len(records)} cases counted OK")
    if args.out:
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
