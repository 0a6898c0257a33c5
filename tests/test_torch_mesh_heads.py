"""Training on a model mesh that does not divide the q heads, against the
JAX package's one-device step, on the CPU.

Where ``model`` divides q's columns ``H*hd`` but not the heads, the
reference's ``fit_spec`` keeps ``model`` on those columns, so a rank's
columns cut across heads. The port's rank runs the heads its columns
touch (``models/layers.py::head_span``): q column-parallel on its own
columns, all-gathered over ``model`` and the span taken
(``dist/parallel.py::gather_span_from_model``, whose backward sums the
ranks' partial gradients of a shared head in rank order), the full k/v
products and the span's KV heads, and the rank's own columns of the
output into its rows of the row-parallel ``o``. Reduced configs whose
head overrides give the production meshes' spans, fp32, the JAX
package's params from ``PRNGKey(0)``, 3 steps (dense, then two at
``paper_default(0.8)`` with ``use_pallas``, lr 5e-5) through
``make_train_step`` (the rank body ``torch_mesh_ranks.seq_train``):

* llama4-like (10 q heads on 2 KV heads) on 1x4: 2.5 heads a rank, a
  span of 3 q heads on one KV head, as llama4-maverick's 40 on 8 at 16;
* whisper-like (6 q and 6 KV heads) on 1x4: 1.5 heads a rank, the KV
  heads neither dividing 4 nor divided by it, as whisper's 20 at 16;
* paligemma-like (2 q heads on one KV head) on 1x4: half a head a rank,
  as paligemma's 8 heads of 256 at 16;
* 3 q and 3 KV heads on a 2x2 ``data x model`` mesh;
* reduced qwen2.5-3b on 1x3, where ``fit_spec`` drops ``model`` from
  every leaf (128 columns, a 512-row vocabulary): every rank runs the
  whole model, no collective over ``model``.

The losses and every final param within 1e-5 of the JAX steps, the kept
channels of every sparse step equal at every site (and every routed
expert's), each rank's ``matmul`` calls equal to the launch table's. One
spawn a world size (4 ranks: the four 1x4 and 2x2 cases; 3 ranks), one
torch thread a rank, a 120-s timeout. Also, without a spawn: the
production meshes' spans, ``mesh_split`` from the fitted specs and what
``mesh_unported`` still names.
"""
import dataclasses

import pytest
import torch_mesh_jax as ref
import torch_mesh_ranks as ranks

from repro_torch.configs.registry import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models import model as tlm

B, S, LR = 4, 16, 5e-5
TIMEOUT_S = 120
# name -> (arch, config overrides, (pod, data, model))
CASES = {
    "llama4-like-1x4": ("llama4-maverick-400b-a17b", dict(n_heads=10, n_kv_heads=2), (1, 1, 4)),
    "whisper-like-1x4": ("whisper-large-v3", dict(n_heads=6, n_kv_heads=6), (1, 1, 4)),
    "paligemma-like-1x4": ("paligemma-3b", dict(n_heads=2, n_kv_heads=1), (1, 1, 4)),
    "three-heads-2x2": ("qwen2.5-3b", dict(n_heads=3, n_kv_heads=3), (1, 2, 2)),
    "qwen-replicated-1x3": ("qwen2.5-3b", {}, (1, 1, 3)),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (arch, overrides, _) in CASES.items():
        jcfg = ref.config(arch, **overrides)
        out[name] = (jcfg, ref.init(jcfg), ref.batches(jcfg, B, S))
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return {name: ref.train(jcfg, tree, data, LR) for name, (jcfg, tree, data) in models.items()}


@pytest.fixture(scope="module")
def port_runs(models):
    """Every case's rank-0 result, one spawn of the cases of each world
    size; the 4-rank spawn also checks the summing gather on 1x4 (6 heads
    of 4 columns) and 2x2 (3 heads): 1.5 heads a rank either way."""
    out = {}
    for world, dm in ((4, (1, 4)), (3, (1, 3))):
        names = [n for n, c in CASES.items() if c[2][1] * c[2][2] == world]
        calls = []
        for n in names:
            arch, overrides, shape = CASES[n]
            _, tree, data = models[n]
            calls.append((ranks.seq_train, (shape, arch, tree, overrides, data, LR)))
        if world == 4:
            calls += [(ranks.span_gather_case, (shape, h, 4)) for shape, h in (((1, 4), 6),
                                                                              ((2, 2), 3))]
            names += ["span-gather-1x4", "span-gather-2x2"]
        got = tmesh.run_on_mesh(ranks.in_turn, *dm, "cpu", calls, timeout_s=TIMEOUT_S)
        out.update(zip(names, got, strict=True))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_split_steps_match_the_jax_one_device_steps(port_runs, jax_runs, name):
    got = port_runs[name]
    ref.assert_matches(got, jax_runs[name], name)
    assert got["matmul_calls"] == got["matmul_table"]
    assert all(n > 0 for n in got["matmul_table"])


@pytest.mark.parametrize("name", ["span-gather-1x4", "span-gather-2x2"])
def test_the_span_gather_sums_the_ranks_gradients(port_runs, name):
    """Two ranks whose spans share a head each send their own gradient
    into its q columns: the rank that holds those columns gets their sum,
    the one-process gradient (fp64), bit for bit the same on a second
    backward; the plain gather, whose backward only slices, would drop the
    other rank's share."""
    every = port_runs[name]
    spans = [res[0].q for res in every]
    assert any(a[1] > b[0] for a, b in zip(spans, spans[1:], strict=False)), spans  # shared
    for span, fwd, err, plain_err, repeat in every:
        assert fwd == 0.0 and err <= 1e-12 and repeat, (span, fwd, err, repeat)
    assert max(res[3] for res in every) > 1e-3


# arch -> q heads a rank, KV heads a rank, at --model-mesh 16
PRODUCTION = {"whisper-large-v3": (2, 2), "paligemma-3b": (1, 1),
              "llama4-maverick-400b-a17b": (3, 1)}


@pytest.mark.parametrize("arch", sorted(PRODUCTION))
def test_the_production_spans(arch):
    """At ``--model-mesh 16`` every rank's columns are whisper's 1.25,
    paligemma's half and llama4's 2.5 heads; the spans need no widening:
    2 heads on 2 KV heads, one q head on the one KV head, 3 q heads on one
    KV head (each KV head serving the span's heads alike, the kernel's
    ``row_id = kvh*G + g``)."""
    cfg = get_config(arch)
    q_n, kv_n = PRODUCTION[arch]
    c = cfg.n_heads * cfg.head_dim // 16
    for r in range(16):
        span = layers.head_span(cfg, 16, r)
        assert (span.q[1] - span.q[0], span.kv[1] - span.kv[0]) == (q_n, kv_n), (r, span)
        assert span.split and span.gather_q and not span.local_kv
        assert span.cols[1] - span.cols[0] == c
        assert span.q[0] * cfg.head_dim + span.cols[0] == r * c
        assert span.kv == layers.kv_range(cfg, tmesh.shape_mesh({"data": 16, "model": 16}, r))


def test_spans_cover_the_columns_and_balance_the_kv_heads():
    """Over a grid of heads, KV heads, head dims and model sizes: a span's
    heads cover the rank's columns, its KV heads are the ones those heads
    read, each serves as many of the span's heads, and the span is the
    heads the columns touch unless that would break the balance (then it
    is whole GQA groups); where ``model`` does not divide the columns,
    every head."""
    widened = 0
    for h in range(1, 13):
        for kv in (k for k in range(1, h + 1) if h % k == 0):
            for hd in (1, 2, 3, 4):
                for m in range(2, 9):
                    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_heads=h,
                                              n_kv_heads=kv, head_dim=hd)
                    g = h // kv
                    for r in range(m):
                        span = layers.head_span(cfg, m, r)
                        if (h * hd) % m:
                            assert span == layers.head_span(cfg, 1, 0) and not span.split
                            continue
                        c = h * hd // m
                        lo, hi = span.q
                        assert lo * hd <= r * c and (r + 1) * c <= hi * hd
                        assert span.cols == (r * c - lo * hd, (r + 1) * c - lo * hd)
                        assert span.kv == (lo // g, (hi - 1) // g + 1)
                        served = {min(hi, (j + 1) * g) - max(lo, j * g) for j in range(*span.kv)}
                        assert len(served) == 1, (h, kv, hd, m, r, span)
                        touched = (r * c // hd, -(-(r + 1) * c // hd))
                        if span.q != touched:
                            widened += 1
                            assert lo % g == 0 and hi % g == 0
                        assert span.gather_q == (span.cols != (0, (hi - lo) * hd))
                        assert span.local_kv == (kv % m == 0)
    assert widened > 0


def test_mesh_split_reads_the_fitted_spec():
    """``fit_spec`` drops ``model`` from every leaf of reduced qwen2.5-3b
    at 3 (128 columns, a 512-row vocabulary): every site ``rep`` and the
    launch table the one-device one; at 2 the columns and rows split. At
    16 whisper's q stays column-parallel (its columns cut across heads)
    and its k/v take the gather route."""
    import repro_torch.core.policy as tpolicy

    cfg = get_config("qwen2.5-3b").reduced()
    sites = tlm.site_names(cfg)[0]
    assert {tlm.mesh_split(cfg, s, 3) for s in sites} == {"rep"}
    assert {s.rsplit("/", 1)[1]: tlm.mesh_split(cfg, s, 2) for s in sites} == {
        "q": "col", "k": "col", "v": "col", "o": "row", "up": "col", "gate": "col",
        "down": "row"}
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    assert tlm.kernel_launches_per_step(cfg, pol, model=3) == tlm.kernel_launches_per_step(cfg,
                                                                                           pol)
    wh = get_config("whisper-large-v3")
    assert [tlm.mesh_split(wh, f"enc/layer_0/attn/{p}", 16) for p in "qkvo"] == [
        "col", "gather", "gather", "row"]


def test_what_mesh_unported_still_names():
    """No q-heads limb and no KV-heads limb: whisper, paligemma and llama4
    at 16 and reduced qwen2.5-3b at 3 and 4 are ported; experts the model
    size does not divide are still named."""
    for arch in PRODUCTION:
        assert tlm.mesh_unported(get_config(arch), 16) == []
    for m in (3, 4):
        assert tlm.mesh_unported(get_config("qwen2.5-3b").reduced(), m) == []
    got = tlm.mesh_unported(get_config("kimi-k2-1t-a32b").reduced(), 3)
    assert got == ["--model-mesh 3 that does not divide the 4 experts"]
