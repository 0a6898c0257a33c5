"""The port's program auditor (``repro_torch.analysis``): the census
against the FLOPs model, the lints' planted regressions, the retrace
budgets against the JAX package's, the launch checks, and the CLI.

The census runs each backward on ``meta`` (nothing allocated). On the
grids of ``tests/test_analysis.py`` (conv: five policies x groups 1, 2 x
``bwd_dtype``; dense: five policies x two dtypes; the strided twin; the
TP fast path) it equals ``core/flops.py``'s bounds exactly on every route
the port runs as torch ops; on the kernel route the products the kernels
are asked for equal the table's unpadded count. The port's table is held
to the JAX package's at each grid point. The JAX walker is no oracle
here: it fails under jax 0.9.0.
"""
import dataclasses

import pytest
import torch

from repro.core import flops as jflops
from repro.core import policy as jpolicy
from repro.analysis import retrace as jretrace
from repro.configs.registry import get_config as jget_config
from repro.serve.scheduler import ServeConfig as JServeConfig
from repro_torch.analysis import dispatch_walk, launch_check, lints, retrace, savings
from repro_torch.analysis.report import ERROR, INFO, Report
from repro_torch.configs.registry import get_config
from repro_torch.core import backward
from repro_torch.core import flops as ftab
from repro_torch.core.policy import (
    PolicyProgram,
    PolicyRules,
    paper_default,
    tpu_default,
)
from repro_torch.core.schedulers import make_schedule
from repro_torch.kernels import specs
from repro_torch.serve.scheduler import ServeConfig


def _policies(mod=None):
    """The JAX tests' five policies (of the port's policy module, or the
    JAX package's with ``mod``)."""
    pol = mod or __import__("repro_torch.core.policy", fromlist=["x"])
    block = pol.tpu_default(0.8)
    return [
        ("dense", pol.DENSE),
        ("channel", pol.paper_default(0.8)),
        ("block", block),
        ("block_pallas", dataclasses.replace(block, use_pallas=True)),
        ("block_pallas_32", dataclasses.replace(block, use_pallas=True, block_size=32)),
    ]


NAMES = [n for n, _ in _policies()]


def _twin(name, **kw):
    """The (port, JAX) policy of one grid point."""
    t = dict(_policies())[name]
    j = dict(_policies(jpolicy))[name]
    return dataclasses.replace(t, **kw), dataclasses.replace(j, **kw)


@pytest.fixture(autouse=True)
def _fresh_census_cache():
    savings.clear_cache()
    yield
    savings.clear_cache()


# ----------------------------------------------------------------------
# the census against the FLOPs model
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pname", NAMES)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("bwd_dtype", ["", "bfloat16"])
def test_conv_census_equals_bounds(pname, groups, bwd_dtype):
    pol, jpol = _twin(pname, bwd_dtype=bwd_dtype)
    rep = Report("t")
    counts = savings.audit_conv_site(rep, "site", 2, 8, 8, 16, 32, 3, pol, groups=groups)
    assert not rep.errors(), [f.message for f in rep.errors()]
    table = ftab.conv_backward_contraction_bounds(2, 8, 8, 16, 32, 3, pol, groups=groups, h_pad=10)
    assert table == jflops.conv_backward_contraction_bounds(2, 8, 8, 16, 32, 3, jpol,
                                                            groups=groups, h_pad=10)
    if counts.launches:  # the kernel route: the products, unpadded
        plain = dataclasses.replace(pol, use_pallas=False)
        assert counts.flops_lo == ftab.conv_backward_contraction_bounds(
            2, 8, 8, 16, 32, 3, plain, groups=groups, h_pad=10)[0]
        assert counts.total_flops == counts.flops + counts.kernel_flops
    else:
        assert (counts.flops_lo, counts.flops_hi) == table


def test_strided_site_audits_via_stride1_twin():
    rep = Report("t")
    counts = savings.audit_conv_site(rep, "site", 2, 4, 4, 16, 32, 3, tpu_default(0.8))
    lo, hi = ftab.conv_backward_contraction_bounds(2, 4, 4, 16, 32, 3, tpu_default(0.8),
                                                   h_pad=4 + 3 - 1)
    assert (counts.flops_lo, counts.flops_hi) == (lo, hi)
    assert not rep.errors()


@pytest.mark.parametrize("pname", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_census_equals_bounds(pname, dtype):
    pol, jpol = _twin(pname)
    rep = Report("t")
    counts = savings.audit_dense_site(rep, "site", 64, 128, 256, pol, dtype=dtype)
    assert not rep.errors(), [f.message for f in rep.errors()]
    table = ftab.dense_backward_contraction_bounds(64, 128, 256, pol)
    assert table == jflops.dense_backward_contraction_bounds(64, 128, 256, jpol)
    assert counts.flops_lo == counts.flops_hi
    if not counts.launches:
        assert (counts.flops_lo, counts.flops_hi) == table


def test_tp_fast_path():
    pol, jpol = _twin("block", tp_shards=2)
    rep = Report("t")
    counts = savings.audit_dense_site(rep, "site", 64, 128, 256, pol)
    assert not rep.errors(), [f.message for f in rep.errors()]
    assert not counts.launches
    assert (counts.flops_lo, counts.flops_hi) == jflops.dense_backward_contraction_bounds(
        64, 128, 256, jpol)


@pytest.mark.parametrize("pname", ["block_pallas", "block_pallas_32"])
def test_kernel_route_reports_tile_flops_against_the_tpu_table(pname):
    """The kernel route's info finding: the kernels' tile FLOPs beside the
    table's TPU-tiled count and their ratio."""
    pol, _ = _twin(pname)
    rep = Report("t")
    counts = savings.audit_conv_site(rep, "site", 2, 8, 8, 16, 32, 3, pol)
    info = [f for f in rep.findings if f.severity == INFO and "kernel route" in f.message]
    assert len(info) == 1
    d = info[0].data
    assert d["tile_flops"] == counts.total_flops
    assert d["ratio"] == pytest.approx(counts.total_flops / d["table"][1])


def test_census_does_not_count_the_plain_version():
    """On the channel kernel route the census counts the two ``matmul``
    launches, not the plain versions' products (nor 3xTF32's three)."""
    pol = dataclasses.replace(paper_default(0.8), use_pallas=True)
    counts = savings.dense_backward_counts(64, 128, 256, pol, "float32")
    assert counts.launches_by_name() == {"matmul": 2}
    assert counts.flops == 0  # no torch-op product: both products are the kernel's
    kept = pol.keep_count(256)
    assert counts.kernel_product_flops == 2 * (2 * 64 * 128 * kept)


class TestLmAudit:
    def test_reduced_decoder_no_errors(self):
        cfg = get_config("qwen2.5-3b").reduced()
        rep = savings.audit_lm(cfg, tpu_default(0.8), batch=2, seq=16)
        assert not rep.errors(), [f.message for f in rep.errors()]

    def test_iter_dense_shapes_equal_the_jax_package(self):
        from repro.models import transformer as jtf
        from repro_torch.models import transformer

        for arch in ("qwen2.5-3b", "kimi-k2-1t-a32b", "whisper-large-v3", "jamba-1.5-large-398b",
                     "mamba2-1.3b"):
            got = list(transformer.iter_dense_shapes(get_config(arch).reduced(), 2, 16))
            want = list(jtf.iter_dense_shapes(jget_config(arch).reduced(), 2, 16))
            assert got == want, arch

    def test_lm_site_flops_rows(self):
        cfg = get_config("qwen2.5-3b").reduced()
        rows = savings.lm_site_flops(cfg, tpu_default(0.8), batch=2, seq=16)
        assert rows
        m = 2 * 16
        for site, count, fwd, lo, hi in rows:
            assert count >= 1 and lo == hi
            if site.endswith("attn/q"):
                assert fwd == 2 * m * cfg.d_model * (cfg.n_heads * cfg.head_dim)

    def test_resnet_and_ddpm_audits_clean(self):
        pol = dataclasses.replace(tpu_default(0.8), use_pallas=True)
        assert not savings.audit_resnet("resnet18", (3, 8, 8), pol, batch=2).errors()
        assert not savings.audit_ddpm((3, 8, 8), dataclasses.replace(pol, block_size=4), batch=2,
                                      base=8).errors()


# ----------------------------------------------------------------------
# the census's conventions
# ----------------------------------------------------------------------


def test_conv_flops_conventions():
    """Forward ``2 B C_out (C_in/G) prod(O_i K_i)``; a strided dX counts the
    cotangent's extent, a stride-1 dX its own; dW counts as the forward."""
    x = torch.empty((2, 4, 9, 9), device="meta", requires_grad=True)
    w = torch.empty((8, 4, 3, 3), device="meta", requires_grad=True)
    y = torch.nn.functional.conv2d(x, w, stride=2, padding=1)  # [2, 8, 5, 5]
    fwd = 2 * 2 * 8 * 4 * 5 * 5 * 3 * 3
    with dispatch_walk.Census() as c:
        g = torch.autograd.grad(y, (x, w), torch.empty_like(y))
    counts = c.finish(g)
    assert [k.op for k in counts.contractions] == ["convolution_backward"]
    assert counts.flops == 2 * fwd  # dX at L_i = 5 (the cotangent), dW as the forward
    y1 = torch.nn.functional.conv2d(x, w, padding=0)  # stride 1: [2, 8, 7, 7]
    with dispatch_walk.Census() as c:
        g = torch.autograd.grad(y1, (x,), torch.empty_like(y1))
    assert c.finish(g).flops == 2 * 2 * 8 * 4 * 9 * 9 * 3 * 3  # dX at its own extent 9


def test_products_dead_and_peak():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")

    def step():
        dead = a @ b  # nothing reads it
        del dead
        live = a @ b
        return (live.relu() + 1).sum()

    with dispatch_walk.Census(args=(a, b)) as c:
        out = step()
    counts = c.finish(out)
    assert [x.live for x in counts.contractions] == [False, True]
    assert counts.dead_flops == counts.flops == 2 * 8 * 16 * 4
    assert counts.arg_bytes == (8 * 16 + 16 * 4) * 4
    assert counts.peak_bytes >= counts.arg_bytes + 2 * 8 * 4 * 4


def test_a_dead_products_storage_handed_out_again_is_no_read():
    """The allocator may give a later output the storage address of a dead
    product: reading that output does not make the product live."""
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")
    reused = []

    def step():
        dead = a @ b  # nothing reads it
        cd = dead.untyped_storage()._cdata
        del dead
        keep = []
        for _ in range(64):  # new outputs, kept alive, until one takes the address
            keep.append(a.relu())
            if keep[-1].untyped_storage()._cdata == cd:
                reused.append(cd)
                break
        return (keep[-1].sum() + (a @ b).sum()).sum()

    with dispatch_walk.Census(args=(a, b)) as c:
        out = step()
    counts = c.finish(out)
    assert reused, "no later output took the dead product's storage address"
    assert [x.live for x in counts.contractions] == [False, True]
    assert counts.dead_flops == 2 * 8 * 16 * 4


def test_converts_and_collectives_are_recorded():
    x = torch.empty((4, 4), device="meta")
    with dispatch_walk.Census() as c:
        x.to(torch.bfloat16)
    counts = c.finish()
    assert [(v.src, v.dst) for v in counts.converts] == [("torch.float32", "torch.bfloat16")]


# ----------------------------------------------------------------------
# planted regressions: each lint catches its plant
# ----------------------------------------------------------------------


class TestSeededRegressions:
    def test_planted_f32_upcast_is_caught(self, monkeypatch):
        policy = dataclasses.replace(tpu_default(0.8), bwd_dtype="bfloat16")
        rep = Report("clean")
        savings.audit_dense_site(rep, "site", 64, 128, 256, policy, dtype="bfloat16")
        assert not rep.errors()
        monkeypatch.setattr(backward, "acc_dtype", lambda p: torch.float32)
        savings.clear_cache()
        rep = Report("seeded")
        savings.audit_dense_site(rep, "site", 64, 128, 256, policy, dtype="bfloat16")
        assert any(f.check == "dtype" for f in rep.errors())

    def test_planted_host_sync_is_caught(self):
        x = torch.empty((4,), device="meta")

        def step(t):
            if (t > 0).any():  # a host sync: the device must finish first
                t = t * 2
            return t[t > 1]  # a boolean mask: another

        with dispatch_walk.Census(args=(x,)) as c:
            out = step(x)
        counts = c.finish(out)
        rep = Report("t")
        lints.lint_step_counts(rep, "t", counts)
        errs = [f for f in rep.errors() if f.check == "transfer"]
        assert {f.data["op"] for f in errs} == {"_local_scalar_dense", "index"}
        assert out.shape == (4,)  # the mask answered with every element set

    def test_adam_update_stalls_no_host(self):
        """Adam's constants are filled on the device: no host-to-device
        copy a step (each stalled the host on the card: three a step)."""
        from repro_torch.optim import adam

        p = {"w": torch.empty((4, 4), device="meta")}
        g = {"w": torch.empty((4, 4), device="meta")}
        opt = adam.init(p)
        with dispatch_walk.Census(args=(p, g, opt)) as c:
            out = adam.apply_updates(adam.AdamConfig(clip_norm=1.0), p, g, opt)
        assert not c.finish(out).syncs
        with dispatch_walk.Census() as c:
            torch.tensor(0.5, device="meta")  # what it did: a pageable copy
        assert [s.op for s in c.finish().syncs] == ["tensor"]

    def test_sync_counts_follow_the_card(self):
        """``bincount`` stalls twice, an in-place scalar ``index_put_``
        once, an integer ``index`` never."""
        x = torch.empty((6,), dtype=torch.long, device="meta")
        flat = torch.zeros((8,), dtype=torch.bool, device="meta")
        with dispatch_walk.Census() as c:
            torch.bincount(x, minlength=8)
            flat[x] = True
            flat[x]
        assert [s.op for s in c.finish().syncs] == ["bincount", "bincount", "index_put_"]

    def test_clean_step_has_no_sync_errors(self):
        x = torch.empty((4,), device="meta")
        with dispatch_walk.Census(args=(x,)) as c:
            out = x * 2
        rep = Report("t")
        lints.lint_step_counts(rep, "t", c.finish(out))
        assert not rep.errors()

    def test_oob_block_idx_is_caught(self):
        bad = specs.dx_gathered_spec(256, 256, 64, 2, 128, 0, block_idx=(0, 2))  # 2 blocks: 0, 1
        rep = Report("t")
        assert not launch_check.check_in_bounds(rep, bad)
        assert any("out of bounds" in f.message for f in rep.errors())
        good = specs.dx_gathered_spec(256, 256, 64, 2, 128, 0, block_idx=(0, 1))
        assert launch_check.check_in_bounds(Report("t"), good)

    def test_oversized_grid_is_caught(self):
        sp = specs.matmul_spec(100, 100, 64, 64, 1, 100, 1, 1, 0, 0)
        big = dataclasses.replace(sp, launches=(dataclasses.replace(sp.launches[0],
                                                                    grid=(3, 2, 1)),))
        rep = Report("t")
        assert not launch_check.check_in_bounds(rep, big)
        assert rep.errors()[0].data["origin"] == [0, 128]

    def test_ragged_operand_is_caught(self):
        pol = dataclasses.replace(tpu_default(0.8), use_pallas=True, block_size=32)
        dw_spec, _, _, passed = launch_check.conv_fused_site_specs(2, 8, 8, 32, 64, 3, pol)
        assert launch_check.check_ragged(Report("t"), dw_spec, passed)
        rep = Report("t")
        ragged = dict(passed, dy2r=(passed["dy2r"][0], passed["dy2r"][1], 48))
        assert not launch_check.check_ragged(rep, dw_spec, ragged)
        bad = specs.conv_dw_fused_spec(2, 10, 1, 10, 32, 8, 8, 48, 48, 3, 3, 1, 1, 1, 1, 1, 32,
                                       1, 0, 0)  # C_pad 48: not whole blocks of 32
        rep = Report("t")
        assert not launch_check.check_ragged(rep, bad)
        assert any("ragged" in f.message for f in rep.errors())

    def test_shared_memory_over_the_limit_is_caught(self):
        sp = specs.matmul_spec(256, 256, 256, 256, 1, 256, 1, 1, 0, 1)  # 132160 B
        assert launch_check.check_smem(Report("t"), sp)
        rep = Report("t")
        assert not launch_check.check_smem(rep, sp, limit=100 * 1024)
        assert rep.errors()[0].data["shared_bytes"] == 132160


class TestLaunchSites:
    def test_fused_conv_site_clean(self):
        pol = dataclasses.replace(tpu_default(0.8), use_pallas=True, block_size=32)
        assert ftab.conv_backward_route(pol, batch=2, h_out=8, w_out=8, c_in=32, c_out=64,
                                        kh=3, kw=3) == "fused"
        rep = Report("t")
        launch_check.check_conv_fused_site(rep, "site", 2, 8, 8, 32, 64, 3, pol)
        assert not rep.errors(), [f.message for f in rep.errors()]
        ratios = [f.data["ratio"] for f in rep.findings if "ratio" in f.data]
        assert len(ratios) == 2 and all(r >= 1 for r in ratios)

    def test_paged_attention_geometry(self):
        rep = Report("t")
        launch_check.check_paged_attention_site(rep, b=2, s=8, h=4, d=32, n_pages=8, bs_pg=16,
                                                kvh=2, nb=4)
        assert not rep.errors(), [f.message for f in rep.errors()]


# ----------------------------------------------------------------------
# retrace budgets, against the JAX package's
# ----------------------------------------------------------------------


def _programs():
    port = PolicyProgram(rules=PolicyRules.single(tpu_default(0.8)),
                         schedule=make_schedule("epoch_bar", target=0.8))
    from repro.core.schedulers import make_schedule as jmake_schedule

    jax_ = jpolicy.PolicyProgram(rules=jpolicy.PolicyRules.single(jpolicy.tpu_default(0.8)),
                                 schedule=jmake_schedule("epoch_bar", target=0.8))
    return port, jax_


def _table_fields(table):
    return [(n, dataclasses.asdict(p)) for n, p in table.entries]


class TestRetrace:
    def test_train_tables_equal_the_jax_package(self):
        port, jax_ = _programs()
        sites = ["layer_0/mlp/up", "layer_0/mlp/down"]
        got, want = retrace.train_tables(port, sites), jretrace.train_tables(jax_, sites)
        assert [_table_fields(t) for t in got] == [_table_fields(t) for t in want]
        assert len(got) <= len(port.schedule.rate_buckets)
        rep = Report("t")
        retrace.check_train_retrace(rep, port, sites)
        assert not rep.errors()

    def test_train_over_budget_fails(self):
        rep = Report("t")
        retrace.check_train_retrace(rep, _programs()[0], ["layer_0/mlp/up"], budget=0)
        assert rep.errors()

    @pytest.mark.parametrize("arch,spec_k", [("qwen2.5-3b", 2), ("qwen2.5-3b", 0),
                                             ("whisper-large-v3", 2)])
    def test_serve_executables_equal_the_jax_package(self, arch, spec_k):
        kw = dict(max_slots=2, max_seq=64, prefill_chunk=8, spec_k=spec_k)
        got = retrace.serve_executables(get_config(arch).reduced(), ServeConfig(**kw))
        want = jretrace.serve_executables(jget_config(arch).reduced(), JServeConfig(**kw))
        assert got == want
        assert retrace.SERVE_JIT_BUDGET == jretrace.SERVE_JIT_BUDGET
        rep = Report("t")
        retrace.check_serve_retrace(rep, get_config(arch).reduced(), ServeConfig(**kw), budget=1)
        assert rep.errors()


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------


class TestAnalyzeCli:
    def test_conv_model_clean(self, tmp_path):
        from repro_torch.launch import analyze

        out = tmp_path / "r.json"
        rc = analyze.main(["--model", "resnet18", "--image", "3,32,32", "--batch", "8",
                           "--use-pallas", "--granularity", "block", "--json", str(out)])
        assert rc == 0
        assert out.exists()

    def test_lm_arch_clean(self):
        from repro_torch.launch import analyze

        assert analyze.main(["--arch", "qwen2.5-3b", "--reduced", "--serve"]) == 0

    def test_step_lint_and_planted_budget(self, capsys):
        from repro_torch.launch import analyze

        assert analyze.main(["--arch", "mamba2-1.3b", "--reduced", "--step-lint"]) == 0
        assert analyze.main(["--arch", "qwen2.5-3b", "--reduced", "--serve",
                             "--smem-limit", "1024"]) == 1
        assert "shared memory" in capsys.readouterr().out


def test_report_renders_and_serialises():
    rep = Report("t")
    rep.add("savings", ERROR, "a", "bad", x=1)
    rep.add("savings", INFO, "b", "fine")
    assert not rep.ok and len(rep.errors()) == 1
    assert "[error] savings  a: bad" in rep.render()
    assert '"ok": false' in rep.to_json()
