"""The port's dry-run on the meta device (``launch/dryrun.py``,
``launch/comm_analysis.py``): the collective cost model and the roofline
on the reference's hand cases with the H100's constants, the recorder
under a fake process group, ``opt_transform`` and ``_supports`` against
the reference for every config, the FLOPs that ``FlopCounterMode``
counts through the plain kernel versions against the analytic model,
``run_case``'s records (and a failed case's), the command line, and the
kernel dispatch of meta tensors."""
import json

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.launch.hlo_analysis import collective_stats as j_collective_stats
from repro.launch.hlo_analysis import roofline_terms as j_roofline_terms
from repro.models.config import INPUT_SHAPES as J_SHAPES
from repro_torch.configs import ALL_CONFIGS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import comm_analysis as CA
from repro_torch.launch import dryrun, flopmodel, hlo_analysis, specs
from repro_torch.launch.mesh import LogicalMesh, make_production_mesh
from repro_torch.models.config import INPUT_SHAPES, InputShape

from test_torch_launch_tooling import reference_dryrun

# the reference's hand-written HLO (tests/test_hlo_analysis.py): one
# all-gather of f32[16] in the entry, an all-reduce of f32[8] in a while
# body run 12 times
HLO = """
HloModule test

%region_body (x: f32[8]) -> f32[8] {
  %ar = f32[8]{0} all-reduce(%x), replica_groups={}
  ROOT %r = f32[8]{0} add(%ar, %ar)
}

%region_cond (x: s32[]) -> pred[] {
  %c = s32[] constant(12)
  ROOT %cmp = pred[] compare(%x, %c), direction=LT
}

ENTRY %main (p: f32[8]) -> f32[8] {
  %ag = f32[16]{0} all-gather(%p), replica_groups={}
  %w = (s32[], f32[8]) while(%t), condition=%region_cond, body=%region_body
  ROOT %out = f32[8]{0} get-tuple-element(%w), index=1
}
"""
# forward FLOPs counted on meta through the plain versions against the
# analytic model: every product the model counts is one the plain
# forward runs (attention over all S keys, as ``_avg_skv`` takes it), so
# they agree to 1%; a train step adds the backward (and remat's second
# forward), within 3% of the analytic multiplier
FWD_BAND = 0.01
TRAIN_BAND = 0.03


def test_collective_stats_matches_reference_hand_case():
    records = [("all-gather", 16 * 4, 1), ("all-reduce", 8 * 4, 12)]
    assert CA.collective_stats(records) == j_collective_stats(HLO)
    assert hlo_analysis.collective_stats is CA.collective_stats


def test_roofline_terms_hand_cases_with_h100_constants():
    """The reference's two cases keep their dominant term; each term is
    the reference's with the TPU v5e constants replaced by the H100's."""
    from repro.launch import hlo_analysis as jh
    for kw in (dict(total_flops=1e18, total_bytes=1e12,
                    collective_bytes_per_device=1e9, chips=256),
               dict(total_flops=1e12, total_bytes=1e12,
                    collective_bytes_per_device=1e12, chips=256)):
        mine, theirs = CA.roofline_terms(**kw), j_roofline_terms(**kw)
        assert mine["dominant"] == theirs["dominant"]
        assert mine["compute_s"] == pytest.approx(
            theirs["compute_s"] * jh.PEAK_FLOPS_BF16 / 989e12, rel=1e-12)
        assert mine["memory_s"] == pytest.approx(
            theirs["memory_s"] * jh.HBM_BW / 3.35e12, rel=1e-12)
        assert mine["collective_s"] == pytest.approx(
            kw["collective_bytes_per_device"] / 50e9, rel=1e-12)
        assert mine["bound_s"] == mine[mine["dominant"]]
    fast = CA.roofline_terms(total_flops=0, total_bytes=0,
                             collective_bytes_per_device=450e9, chips=8,
                             link_bytes_per_s=CA.NVLINK_BYTES_PER_S)
    assert fast["collective_s"] == pytest.approx(1.0)


def test_link_rate_per_mesh_axis():
    """NVLink inside an 8-GPU node, the network across nodes."""
    one = make_production_mesh()
    assert CA.link_bytes_per_s(one, ("data",)) == CA.NETWORK_BYTES_PER_S
    assert CA.link_bytes_per_s(one, ("model",)) == CA.NETWORK_BYTES_PER_S
    tp8 = LogicalMesh(("data", "model"), (32, 8))
    assert CA.link_bytes_per_s(tp8, ("model",)) == CA.NVLINK_BYTES_PER_S
    assert CA.link_bytes_per_s(tp8, ("data",)) == CA.NETWORK_BYTES_PER_S
    pod = make_production_mesh(multi_pod=True)
    assert CA.link_bytes_per_s(pod, ("pod", "data")) == \
        CA.NETWORK_BYTES_PER_S


def test_recorder_under_a_fake_world_of_meta_tensors():
    """A fake world of 256 ranks: an all_gather into a list, an
    all_gather into a tensor and an all_reduce, each on meta tensors,
    recorded with its result bytes and costed as the reference costs
    them; outside the block the functions are torch's own again."""
    x = torch.empty(4, 8, device="meta")
    before = dist.all_reduce
    with CA.fake_world(256), CA.record_collectives() as recs:
        assert dist.get_world_size() == 256
        outs = [torch.empty_like(x) for _ in range(256)]
        dist.all_gather(outs, x, async_op=True).wait()
        dist.all_gather_into_tensor(torch.empty(1024, 8, device="meta"), x)
        dist.all_reduce(x)
    assert not dist.is_initialized() and dist.all_reduce is before
    assert recs == [("all-gather", 256 * 128, 1), ("all-gather", 1024 * 32, 1),
                    ("all-reduce", 128, 1)]
    stats = CA.collective_stats(recs)
    assert stats["counts"] == {"all-gather": 2, "all-reduce": 1}
    assert stats["total_bytes"] == 256 * 128 + 1024 * 32 + 2 * 128


def test_fake_world_refuses_beside_an_existing_group():
    """The fake world cannot sit beside a default group: it says so."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already has a default"):
            with CA.fake_world(4):
                pass
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ALL_CONFIGS)
def test_opt_transform_and_supports_match_reference(name):
    import dataclasses
    jd = reference_dryrun()
    cfg, jcfg = get_config(name), jget(name)
    assert dataclasses.asdict(dryrun.opt_transform(cfg)) == \
        dataclasses.asdict(jd.opt_transform(jcfg))
    for shape in INPUT_SHAPES:
        assert dryrun._supports(cfg, INPUT_SHAPES[shape]) == \
            jd._supports(jcfg, J_SHAPES[shape])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_counted_flops_within_band_of_analyze(kind):
    """dipaco-150m at smoke size on a mesh of 2 workers: the FLOPs counted
    through the plain versions on meta tensors, over both ranks, against
    ``analyze``'s forward (prefill, decode) or whole step (train)."""
    cfg = get_smoke_config("dipaco-150m").replace(attn_impl="pallas")
    shape = InputShape("smoke", 64, 4, kind)
    case = specs.build_case(cfg, shape, LogicalMesh(("data", "model"),
                                                    (2, 1)))
    flops, records = dryrun.count_step(case)
    assert records == []          # one worker a rank: no collective
    rep = flopmodel.analyze(cfg, shape, num_workers=2)
    if kind == "train":
        assert abs(2 * flops / rep.total_flops - 1) < TRAIN_BAND
    else:
        assert abs(2 * flops / rep.fwd_flops - 1) < FWD_BAND


def test_run_case_records_every_shape_of_dipaco_150m():
    """The four shapes on the 16x16 mesh with the outer step: every record
    ``ok`` with counted and analytic FLOPs, bytes, memory and an H100
    roofline; the inner steps call no collective, the outer step one
    16-way all_gather a leaf."""
    for name in INPUT_SHAPES:
        rec = dryrun.run_case("dipaco-150m", name, multi_pod=False,
                              with_outer=True, verbose=False)
        assert rec["ok"], rec.get("traceback")
        for k in ("counted_flops", "total_flops", "total_bytes",
                  "fwd_flops", "flop_breakdown", "memory", "roofline",
                  "model_flops", "useful_flops_ratio", "collectives"):
            assert k in rec, k
        assert rec["collectives"]["total_count"] == 0
        band = TRAIN_BAND if name == "train_4k" else FWD_BAND
        assert abs(rec["counted_flops"] / rec["total_flops"] - 1) < band
        mem = rec["memory"]
        assert mem["per_rank"]["params"] > mem["per_device"]["params"] > 0
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
        if name == "train_4k":
            outer = rec["outer"]["collectives"]
            assert outer["counts"] == {"all-gather": 10}
            assert outer["total_bytes"] == pytest.approx(
                16 * 4 * specs.active_param_count(get_config(
                    "dipaco-150m"))[0])


def test_failed_case_is_recorded_with_its_error():
    """256 workers cannot split decode_32k's 128 requests: the case is
    recorded as failed, with its error and traceback, and no number."""
    rec = dryrun.run_case("qwen3-8b", "decode_32k", multi_pod=False, tp=1,
                          verbose=False)
    assert rec["ok"] is False and rec["mesh"] == "256x1"
    assert rec["error"].startswith("AssertionError")
    assert "Traceback" in rec["traceback"]
    assert "counted_flops" not in rec and "roofline" not in rec


def test_command_line_writes_records(tmp_path, capsys):
    out = tmp_path / "d.json"
    dryrun.main(["--arch", "dipaco-150m", "--shape", "decode_32k",
                 "--both-meshes", "--variant", "opt", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["ok"] and r["variant"] == "opt" for r in recs)
    assert "2/2 cases counted OK" in capsys.readouterr().out


def test_meta_tensors_take_the_plain_kernel_versions():
    """ops on meta tensors: the plain versions' shapes, no launch."""
    m = dict(device="meta")
    q = torch.empty(2, 32, 4, 16, **m)
    kv = torch.empty(2, 32, 2, 16, **m)
    assert ops.flash_attention(q, kv, kv).shape == q.shape
    o, lse = ops.fwd_with_lse(q, kv, kv)
    assert lse.shape == (2, 4, 32) and lse.device.type == "meta"
    cache = torch.empty(2, 64, 2, 16, **m)
    ci = torch.empty(2, dtype=torch.int32, **m)
    assert ops.decode_attention(q[:, 0], cache, cache, ci).shape == (2, 4, 16)
    xe, w = torch.empty(3, 5, 8, **m), torch.empty(3, 8, 6, **m)
    assert ops.expert_gemm(xe, w).shape == (3, 5, 6)
    y, st = ops.ssd_scan(torch.empty(1, 64, 4, 8, **m),
                         torch.empty(1, 64, 4, **m), torch.empty(4, **m),
                         torch.empty(1, 64, 1, 16, **m),
                         torch.empty(1, 64, 1, 16, **m), chunk=32)
    assert y.shape == (1, 64, 4, 8) and st.shape == (1, 4, 8, 16)
