"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and its census on the fake process group against real ranks.

* Placements: every arch x shape x ``single|multi`` mesh under ``ssprop``
  and ``opt``, the port's report equal to the JAX dry run's leaf for leaf
  (its ``PartitionSpec`` strings less their prefix), ``train_tight``'s
  joint ``('pod', 'data')`` split among them; the per-rank argument bytes
  equal to the sums of the JAX ``NamedSharding.shard_shape`` sizes. The
  JAX side comes from one subprocess with 512 placeholder devices
  (``REPRO_DRYRUN_DEVICES``), every cell in it, as
  ``tests/test_multiprocess.py::test_dryrun_joint_fit_spec_placement``
  gets its own.
* Fake vs real: the dry run's census of one step of reduced qwen2.5-3b
  and reduced kimi-k2 at 1x2 and 2x1, each rank on the fake group,
  records the collective calls and bytes and the kernel launches (wrapper
  calls) the gloo ranks of ``tests/torch_mesh_ranks.py`` record.
* The twins the dry run reads: ``ShapeConfig`` / ``SHAPES`` /
  ``supports_shape``, ``input_specs``, ``microbatch_plan``,
  ``abstract_state``, ``abstract_cache`` and ``make_prefill_step``.
* Every cell's status: ``ok``, ``unsupported`` with the CLI's refusal, or
  ``skipped``; a full-width train cell (depth cut) runs as rank 0 of the
  16x16 and of the 2x16x16 mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import policy as tpolicy
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers
from repro_torch.models import model as tlm
from repro_torch.optim import adam as tadam

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
SHAPES = list(tbase.SHAPES)
MESHES = ("single", "multi")
POLICIES = ("ssprop", "opt")

# the JAX dry run's placements and per-rank argument bytes of every cell,
# one process with 512 placeholder devices (both meshes fit in it)
_JAX_CELLS = r"""
import json, sys
import repro.launch.dryrun as d  # sets XLA_FLAGS before jax is imported
import jax
import numpy as np
from repro.configs.base import SHAPES
from repro.configs.registry import ARCH_IDS
out = {}
for mesh_kind in ("single", "multi"):
    mesh = d.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    for pol in ("ssprop", "opt"):
        for a in ARCH_IDS:
            for s in SHAPES:
                fn, args, meta = d.build_cell(a, s, mesh, pol)
                key = "|".join((a, s, mesh_kind, pol))
                if fn is None:
                    out[key] = None
                    continue
                nbytes = [int(sum(np.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
                                  for l in jax.tree.leaves(t))) for t in args]
                out[key] = {"placements": d._placement_report(args), "bytes": nbytes}
print(json.dumps(out))
"""


def _norm(spec: str) -> str:
    return spec[len("PartitionSpec"):] if spec.startswith("PartitionSpec") else spec


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="512", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_CELLS], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_and_rank_bytes_equal_the_jax_dry_run(jax_cells, arch, shape, mesh_kind,
                                                         policy):
    want = jax_cells["|".join((arch, shape, mesh_kind, policy))]
    rec = dryrun.run_cell(arch, shape, mesh_kind, policy, verbose=False, placements_only=True)
    if want is None:
        assert rec["status"] == "skipped"
        return
    jp = want["placements"]
    assert rec["placements"]["param_spec_histogram"] == {
        _norm(k): v for k, v in jp["param_spec_histogram"].items()}
    assert rec["placements"]["inputs"] == {k: _norm(v) for k, v in jp["inputs"].items()}
    rb = rec["rank_bytes"]
    names = ["params"] + [n for n in ("adam", "batch", "state") if n in rb]
    # a decode cell's state and a train cell's batch by the reference's spec
    # (``state`` and ``batch`` are the port's rank's, reported beside it
    # where the two differ: whisper's train_tight frames, held whole)
    ref = dict(rb, state=rb.get("state_reference", rb.get("state")),
               batch=rb.get("batch_reference", rb.get("batch")))
    assert [ref[n] for n in names] == want["bytes"]
    if (shape, mesh_kind) == ("train_tight", "multi"):  # the joint split: pod on B, data on S
        assert rec["placements"]["inputs"]["['tokens']"] == "('pod', 'data')"


def test_placements_only_cli_exits_zero(capsys):
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_tight", "--mesh", "multi",
                        "--placements-only"]) == 0
    payload = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
    assert payload["inputs"]["['tokens']"] == "('pod', 'data')"


# ----------------------------------------------------------------------
# the twins the dry run reads
# ----------------------------------------------------------------------


def test_shape_twins_jax():
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for name, sh in tbase.SHAPES.items():
        assert dataclasses.asdict(sh) == dataclasses.asdict(jbase.SHAPES[name])
    for arch in ARCH_IDS:
        for name in tbase.SHAPES:
            assert (get_config(arch).supports_shape(tbase.SHAPES[name])
                    == jget_config(arch).supports_shape(jbase.SHAPES[name])), (arch, name)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-large-v3", "paligemma-3b",
                                  "mistral-large-123b"])
def test_input_specs_and_microbatch_plan_equal_the_jax_package(arch):
    for name in tbase.SHAPES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        got = tpipeline.input_specs(cfg, tbase.SHAPES[name])
        want = jpipeline.input_specs(jcfg, jbase.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), (name, k)
        for dp in (1, 16, 32):
            assert (tsteps.microbatch_plan(cfg, tbase.SHAPES[name], dp)
                    == jsteps.microbatch_plan(jcfg, jbase.SHAPES[name], dp))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
def test_abstract_state_and_cache_are_the_jax_shapes(arch):
    """Full width, on meta: the params (in the JAX layout), the Adam
    moments and the cache have the JAX package's abstract shapes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    params, opt = tsteps.abstract_state(cfg)
    assert all(t.device.type == "meta" for t in tadam.tree_leaves([params, opt.m, opt.v]))
    a_params, _ = jsteps.abstract_state(jcfg)
    jl = tlm.jax_layout(cfg, params, tlm.StackShape)
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in dryrun._paths(jl)}
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(a_params)[0]}
    assert got == want
    assert opt.m["embed"]["table"].dtype == torch.float32
    cache = tlm.jax_cache_layout(cfg, tsteps.abstract_cache(cfg, 2, 64))
    a_cache = jsteps.abstract_cache(jcfg, 2, 64)
    got = {p: tuple(x.shape) for p, x in dryrun._paths(cache)}
    want = {jax.tree_util.keystr(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(a_cache)[0]}
    assert got == want


def test_prefill_step_equals_the_jax_package():
    """``make_prefill_step`` on the CPU gives the JAX prefill's tokens
    (reduced qwen2.5-3b, the same params)."""
    jcfg = jget_config("qwen2.5-3b").reduced()
    cfg = get_config("qwen2.5-3b").reduced()
    tree = jax.device_get(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = np.asarray(jsteps.make_prefill_step(jcfg)(tree, {"tokens": toks}))
    got = tsteps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# every cell's status
# ----------------------------------------------------------------------


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("policy", POLICIES)
def test_every_cell_is_ok_unsupported_or_skipped(mesh_kind, policy):
    """No cell is refused: every cell the arch can take runs. Among them
    train cells whose batch the data mesh does not divide (``train_tight``:
    ``data`` on the sequence; whisper's frames whole past their rows, the
    encoder alike on the sequence group; paligemma's patch block beside its
    token block), ``--data-mesh`` serving, the lock-step engine on a mesh,
    the seq-sharded decode under ``opt``, and a model mesh that cuts the q
    heads (whisper, paligemma, llama4: each rank runs its head span)."""
    ms = tmesh.production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    for arch in ARCH_IDS:
        for shape in SHAPES:
            cell, why = dryrun.build_cell(arch, shape, ms, policy)
            if cell is None:
                assert shape == "long_500k" and "full-attention" in why
                continue
            msg = dryrun.refusal(cell, ms, policy)
            kind = tbase.SHAPES[shape].kind
            assert tlm.mesh_unported(cell.cfg, 16) == []
            assert msg == "", (arch, shape, msg)
            if kind == "train":
                blk = cell.meta.get("batch_block")
                assert (blk is not None) == (shape == "train_tight"), (arch, shape)
            if shape == "train_tight" and arch == "whisper-large-v3":
                assert [w.split(":")[0] for w in blk["whole"]] == ["frames"], blk
                assert "d_model" in blk["whole"][0] and "patches" not in blk
            elif shape == "train_tight" and arch == "paligemma-3b":
                assert blk["patches"] == [0, 16] and "whole" not in blk, blk
            elif kind == "train" and blk is not None:
                assert "patches" not in blk and "whole" not in blk, blk


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    tmesh._fake.clear()


@pytest.mark.parametrize("multi", [False, True])
def test_full_width_train_cell_runs_on_meta(fake_group, multi):
    """qwen2.5-3b at full width (depth cut to 2) x train_4k as rank 0 of
    the production mesh on the fake group: the step runs, allocates
    nothing, and counts its collectives, FLOPs and peak."""
    ms = tmesh.production_mesh_shape(multi_pod=multi)
    cell, _ = dryrun.build_cell("qwen2.5-3b", "train_4k", ms, "ssprop")
    cell.cfg = dataclasses.replace(cell.cfg, n_layers=2)
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    assert mesh.world == (512 if multi else 256) and mesh.device.type == "meta"
    rec = dryrun.census_record(dryrun.step_census(cell, mesh))
    assert rec["flops"] > 0 and rec["collective_calls"] > 0
    assert rec["peak_bytes"] > rec["arg_bytes"] > 0
    assert set(rec["collectives"]) <= {"all-reduce", "all-gather"}
    assert rec["launches"] == {}  # tpu_default runs the gather route


@pytest.mark.parametrize("multi", [False, True])
def test_full_width_train_tight_cell_steps_its_sequence_block(fake_group, multi):
    """qwen2.5-3b at full width (depth cut to 2) x train_tight (batch 8 of
    4096 tokens) as rank 0 of the production mesh: 16 data ranks do not
    divide the batch, so ``data`` takes the sequence (256 positions a
    rank) and on 2x16x16 ``pod`` keeps the batch (4 rows a pod). The rank
    steps its ``[8, 256]`` / ``[4, 256]`` block: each attention layer
    gathers its K/V over ``data`` (one all-gather forward, one all-reduce
    backward), and the step's collectives are what the census counts."""
    from repro_torch.dist import parallel

    ms = tmesh.production_mesh_shape(multi_pod=multi)
    cell, _ = dryrun.build_cell("qwen2.5-3b", "train_tight", ms, "ssprop")
    cell.cfg = dataclasses.replace(cell.cfg, n_layers=2)
    rows = 4 if multi else 8
    assert cell.meta["batch_block"] == {"rows": [0, rows], "seq": [0, 256],
                                        "batch_axes": ["pod"] if multi else [],
                                        "seq_axes": ["data"]}
    assert cell.meta["accum"] == 1
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    layout = tlm.batch_layout(cell.cfg, mesh, 8, 4096)
    assert (layout.rows, layout.seq) == ((0, rows), (0, 256))
    assert layout.step_mesh(mesh).dp == (32 if multi else 16)
    parallel.counters.update(calls=0, bytes=0, seq_calls=0, seq_bytes=0)
    counts = dryrun.step_census(cell, mesh)
    rec = dryrun.census_record(counts)
    assert counts.arg_bytes > 0 and rec["flops"] > 0
    lo, hi = layers.kv_range(cell.cfg, mesh)  # the KV head the rank's q head reads
    kv = 2 * rows * 256 * (hi - lo) * cell.cfg.head_dim * 2  # the block's k and v, bf16
    assert parallel.counters["seq_calls"] == 2 * 2  # a gather and its all-reduce a layer
    assert parallel.counters["seq_bytes"] == 2 * (kv + 16 * kv)
    assert parallel.counters["calls"] == rec["collective_calls"]
    assert parallel.counters["bytes"] == rec["collective_bytes"]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_full_width_family_train_tight_cells_split_the_sequence(fake_group, arch, multi):
    """whisper and paligemma at full width (depth cut to 1, whisper 1 + 1)
    x train_tight as rank 0 of the production mesh on the fake group.
    ``data`` takes the tokens' sequence (256 a rank) and on 2x16x16
    ``pod`` the batch. whisper's 1500 frames are whole past their rows
    (``fit_spec`` puts ``data`` on ``d_model``): the encoder gathers
    nothing, its decoder layer's self-attention gathers its K/V over
    ``data``, and the cross-attention's K/V gradient is summed over
    ``data`` (one all-reduce of the rank's K/V heads over its rows' 1500
    frames, counted apart). paligemma's 256 patches split with the tokens
    (16 a rank, positions ``16r ..`` then ``256 + 256r ..``), its one
    attention layer gathering 272 positions a rank. The step's
    collectives are what the census counts."""
    from repro_torch.dist import parallel

    ms = tmesh.production_mesh_shape(multi_pod=multi)
    cell, _ = dryrun.build_cell(arch, "train_tight", ms, "ssprop")
    encdec = arch == "whisper-large-v3"
    cell.cfg = dataclasses.replace(cell.cfg, n_layers=1, **({"n_enc_layers": 1} if encdec else {}))
    rows = 4 if multi else 8
    assert dryrun.refusal(cell, ms, "ssprop") == ""
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    layout = tlm.batch_layout(cell.cfg, mesh, 8, 4096)
    assert (layout.rows, layout.seq) == ((0, rows), (0, 256))
    assert layout.patches == ((0, 0) if encdec else (0, 16))
    assert layout.positions("meta").shape == (256 if encdec else 272,)
    parallel.counters.update(calls=0, bytes=0, seq_calls=0, seq_bytes=0, kv_sum_calls=0,
                             kv_sum_bytes=0)
    rec = dryrun.census_record(dryrun.step_census(cell, mesh))
    assert rec["flops"] > 0
    lo, hi = layers.kv_range(cell.cfg, mesh)
    kv = 2 * rows * (hi - lo) * cell.cfg.head_dim * 2  # k and v of one position, bf16
    own = kv * (256 + (0 if encdec else 16))
    sums = 2 * rows * 1500 * (hi - lo) * cell.cfg.head_dim * 2 if encdec else 0
    assert (parallel.counters["kv_sum_calls"], parallel.counters["kv_sum_bytes"]) == (
        int(encdec), sums)
    assert parallel.counters["seq_calls"] == 2 + int(encdec)
    assert parallel.counters["seq_bytes"] == own + 16 * own + sums
    assert parallel.counters["calls"] == rec["collective_calls"]
    assert parallel.counters["bytes"] == rec["collective_bytes"]


def test_the_kernel_route_counts_its_launches(fake_group):
    """With ``use_pallas`` on a model mesh of 16, a rank launches what the
    launch table says (the full-selection channels in its columns)."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    shape = tbase.ShapeConfig("t", 128, 16, "train")
    ms = {"data": 16, "model": 16}
    cell = dryrun.make_cell(cfg, shape, pol, ms)
    cell.meta["accum"] = 1
    mesh = tmesh.make_fake_mesh(16, 16)
    counts = dryrun.step_census(cell, mesh)
    want = tlm.kernel_launches_per_step(cfg, pol, model=16, data=16, tokens=16 * 128)
    assert counts.launches_by_name() == {k: v for k, v in want.items() if v}


# ----------------------------------------------------------------------
# the census on the fake group against real gloo ranks
# ----------------------------------------------------------------------

FVR_ARCHS = ("qwen2.5-3b", "kimi-k2-1t-a32b")
FVR_SHAPES = ((1, 2), (2, 1))
FVR_BATCH, FVR_SEQ = 4, 16


@pytest.fixture(scope="module")
def real_ranks():
    import torch_mesh_ranks as ranks

    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    calls = {sh: (ranks.in_turn, ([(ranks.counted_step, (a, pol, FVR_BATCH, FVR_SEQ))
                                   for a in FVR_ARCHS],)) for sh in FVR_SHAPES}
    res = tmesh.run_on_mesh(ranks.on_shapes, *FVR_SHAPES[0], "cpu", calls, timeout_s=240)
    return {(sh, a): every for sh, outs in res.items()
            for a, every in zip(FVR_ARCHS, outs, strict=True)}


@pytest.mark.parametrize("shape", FVR_SHAPES)
@pytest.mark.parametrize("arch", FVR_ARCHS)
def test_fake_group_census_equals_real_ranks(real_ranks, fake_group, arch, shape):
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    cfg = get_config(arch).reduced()
    sh = tbase.ShapeConfig("t", FVR_SEQ, FVR_BATCH, "train")
    cell = dryrun.make_cell(cfg, sh, pol, {"data": shape[0], "model": shape[1]})
    cell.meta["accum"] = 1
    rb = dryrun.rank_bytes(cell, {"data": shape[0], "model": shape[1]})
    for real in real_ranks[(shape, arch)]:
        mesh = tmesh.make_fake_mesh(*shape, rank=real["rank"])
        counts = dryrun.step_census(cell, mesh)
        rec = dryrun.census_record(counts)
        assert (rec["collective_calls"], rec["collective_bytes"]) == (real["calls"],
                                                                      real["bytes"]), real
        assert rec["launches"] == real["launches"] and real["launches"]["matmul"] > 0, real
        assert (rb["params"], rb["adam"]) == (real["param_bytes"], real["adam_bytes"])


@pytest.mark.parametrize("kind, policy", [("decode", "ssprop"), ("decode", "opt"),
                                          ("prefill", "ssprop")])
def test_fake_2x2_serving_cell_census_bytes_are_rank_bytes(fake_group, kind, policy):
    """A serving cell of the reduced config on a fake 2x2 group, each rank:
    the step runs (decode: the lock-step ``make_serve_step`` on the rank's
    rows and cache shard, the sequence over ``model`` and the k/v kernels
    whole under ``opt``), and its census's argument bytes are the cell's
    ``rank_bytes``: the params' shards by the specs, and the rank's rows
    and cache as the port holds them (``pos`` a host int). (Under ``opt``
    the reference replicates k/v in every cell; the port's prefill step
    keeps them split, so there the two differ.)"""
    ms = {"data": 2, "model": 2}
    cfg = get_config("qwen2.5-3b").reduced()
    if policy == "opt":
        cfg = dataclasses.replace(cfg, decode_seq_shard=True)
    shape = tbase.ShapeConfig("t", 32, 4, kind)
    cell = dryrun.make_cell(cfg, shape, tpolicy.tpu_default(0.8), ms, opt=policy == "opt")
    rb = dryrun.rank_bytes(cell, ms)
    for rank in range(4):
        rec = dryrun.census_record(dryrun.step_census(cell, tmesh.make_fake_mesh(2, 2, rank=rank)))
        assert rec["arg_bytes"] == rb["total"], (rank, rec["arg_bytes"], rb)
        assert rec["flops"] > 0 and rec["collective_calls"] > 0
    if kind == "decode":
        assert cell.meta["cache_layout"] == {"slots": [0, 2],
                                             "seq": "model" if policy == "opt" else None}
        assert rb["cache"] < rb["state"]


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_clis_refuse_a_model_mesh_that_splits_heads_unevenly(cli):
    """The command lines that were refused for a model mesh that does not
    divide the q heads (reduced qwen2.5-3b's 4 at 3, where ``fit_spec``
    drops ``model`` from every leaf: every rank runs the whole model) run
    and finish with the one-device CLI's losses within 1e-5, or its tokens."""
    from repro_torch.launch import serve, train

    mod = train if cli == "train" else serve
    argv = ["--device", "cpu", "--reduced"]
    if cli == "train":
        argv += ["--steps", "3", "--steps-per-epoch", "1", "--global-batch", "4", "--seq-len",
                 "16", "--use-pallas", "--log-every", "100"]
    else:
        argv += ["--batch", "2", "--requests", "4", "--prompt-len", "12", "--gen", "8",
                 "--prefill-chunk", "4", "--block-size", "4"]
    one = mod.run(mod.build_parser().parse_args(argv))
    got = mod.run(mod.build_parser().parse_args(argv + ["--model-mesh", "3"]), timeout_s=120)
    if cli == "train":
        assert len(got["history"]) == 3
        for a, b in zip(got["history"], one["history"], strict=True):
            assert abs(a - b) <= 1e-5 * abs(b), (got["history"], one["history"])
    else:
        assert got["generated"].tolist() == one["generated"].tolist()
