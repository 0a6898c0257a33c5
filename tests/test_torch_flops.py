"""The port's backward-FLOPs model and the paper's task configs against
the JAX package's, integer for integer.

Every ported function of ``core/flops.py`` over a grid of geometries
(ragged channel tails included) and policies (dense, the nominal 0.8,
``paper_default``, ``tpu_default`` at block sizes 4, 32 and 128, with
and without ``use_pallas``, one-sided sparsity); the model walks
``resnet.flops_per_iter`` and ``ddpm.flops_per_iter`` at every
``CLASSIFICATION`` / ``GENERATION`` task; the configs field by field.
"""
import dataclasses

import pytest

from repro.configs import paper as jpaper
from repro.core import flops as jflops
from repro.core import policy as jpolicy
from repro.models import ddpm as jddpm
from repro.models import resnet as jresnet
from repro_torch.configs import paper as tpaper
from repro_torch.core import flops as tflops
from repro_torch.core import policy as tpolicy
from repro_torch.models import ddpm as tddpm
from repro_torch.models import resnet as tresnet

# (Bt, H_out, W_out, C_in, C_out, K): the ragged 3-channel head and
# stem, 1x1 skips, concatenated inputs, widths that are not a multiple
# of the block, a 7x7 stem
GEOMETRIES = [
    (128, 64, 64, 64, 3, 3),
    (128, 64, 64, 3, 64, 3),
    (128, 64, 64, 128, 64, 1),
    (128, 16, 16, 256, 128, 3),
    (4, 8, 8, 8, 16, 3),
    (2, 7, 5, 12, 130, 3),
    (16, 112, 112, 3, 64, 7),
    (32, 4, 4, 512, 512, 1),
]


def _policies():
    """(name, JAX policy, port policy) pairs over the grid."""
    out = [("dense", jpolicy.SsPropPolicy(0.0), tpolicy.SsPropPolicy(0.0)),
           ("nominal", jpolicy.SsPropPolicy(0.8), tpolicy.SsPropPolicy(0.8)),
           ("paper_default", jpolicy.paper_default(0.8), tpolicy.paper_default(0.8))]
    for bs in (4, 32, 128):
        for kw in (dict(), dict(use_pallas=True), dict(use_pallas=True, sparsify_dx=False),
                   dict(sparsify_dw=False)):
            jp = dataclasses.replace(jpolicy.tpu_default(0.8), block_size=bs, **kw)
            tp = dataclasses.replace(tpolicy.tpu_default(0.8), block_size=bs, **kw)
            out.append((f"tpu_default bs={bs} {kw}", jp, tp))
    out.append(("paper_default use_pallas",
                dataclasses.replace(jpolicy.paper_default(0.5), use_pallas=True),
                dataclasses.replace(tpolicy.paper_default(0.5), use_pallas=True)))
    return out


POLICIES = _policies()


@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_conv_flops_match(geo):
    bt, h, w, c_in, c_out, k = geo
    assert tflops.conv_backward_flops(*geo) == jflops.conv_backward_flops(*geo)
    for d in (0.0, 0.25, 0.5, 0.8, 0.95):
        assert tflops.conv_backward_flops_ssprop(*geo, d) == \
            jflops.conv_backward_flops_ssprop(*geo, d)
        assert tflops.conv_layer_report(*geo, d) == jflops.conv_layer_report(*geo, d)
    assert tflops.batchnorm_backward_flops(bt, h, w, c_out) == \
        jflops.batchnorm_backward_flops(bt, h, w, c_out)
    assert tflops.dropout_backward_flops(bt, h, w, c_out) == \
        jflops.dropout_backward_flops(bt, h, w, c_out)
    assert tflops.drop_rate_lower_bound(c_in, k) == jflops.drop_rate_lower_bound(c_in, k)
    for name, jp, tp in POLICIES:
        assert tflops.conv_backward_flops_policy(*geo, tp) == \
            jflops.conv_backward_flops_policy(*geo, jp), name
        assert tflops.conv_backward_flops_site(*geo, tp, "x") == \
            jflops.conv_backward_flops_site(*geo, jp, "x"), name
        assert tflops.conv_layer_report(*geo, 0.8, tp) == \
            jflops.conv_layer_report(*geo, 0.8, jp), name
        assert tflops.gather_width(c_out, tp) == jflops.gather_width(c_out, jp), name
        assert tflops.effective_drop_rate(c_out, tp) == jflops.effective_drop_rate(c_out, jp)
        for shards in (2, 4):
            if c_out % shards == 0:
                assert tflops.gather_width(c_out, tp, shards) == \
                    jflops.gather_width(c_out, jp, shards), (name, shards)


@pytest.mark.parametrize("m,d_in,d_out", [(1024, 2048, 256), (96, 27, 64), (7, 130, 3)])
def test_dense_flops_match(m, d_in, d_out):
    for bias in (True, False):
        assert tflops.dense_backward_flops(m, d_in, d_out, bias) == \
            jflops.dense_backward_flops(m, d_in, d_out, bias)
        for d in (0.0, 0.5, 0.8):
            assert tflops.dense_backward_flops_ssprop(m, d_in, d_out, d, bias) == \
                jflops.dense_backward_flops_ssprop(m, d_in, d_out, d, bias)
        for name, jp, tp in POLICIES:
            assert tflops.dense_backward_flops_policy(m, d_in, d_out, tp, bias) == \
                jflops.dense_backward_flops_policy(m, d_in, d_out, jp, bias), name
            assert tflops.dense_backward_flops_site(m, d_in, d_out, tp, "y", bias) == \
                jflops.dense_backward_flops_site(m, d_in, d_out, jp, "y", bias), name
    assert tflops.savings_fraction(0, 5) == jflops.savings_fraction(0, 5) == 0.0
    assert tflops.savings_fraction(10, 4) == jflops.savings_fraction(10, 4)


def test_site_tables_count_each_site_at_its_own_policy():
    """A per-site program over the UNet: the stem dense, the outer levels
    at 0.5, the rest at the block-32 kernel route; both packages' walks
    count each conv at its own site's keep count."""
    base = dict(granularity="block", block_size=32, use_pallas=True)
    text = "stem=dense;{down1,up1}/*=0.5;*=0.8"
    sites, depth = tddpm.site_names(64)
    tt = tpolicy.PolicyRules.parse(text, tpolicy.SsPropPolicy(0.8, **base)).resolve(
        sites, depth=depth)
    jt = jpolicy.PolicyRules.parse(text, jpolicy.SsPropPolicy(0.8, **base)).resolve(
        sites, depth=depth)
    got = tddpm.flops_per_iter(128, (3, 64, 64), policy=tt)
    assert got == jddpm.flops_per_iter(128, (3, 64, 64), policy=jt)
    assert got != tddpm.flops_per_iter(128, (3, 64, 64), policy=tt["mid1/conv1"])


@pytest.mark.parametrize("key", sorted(jpaper.CLASSIFICATION), ids=str)
def test_resnet_flops_per_iter_at_every_paper_task(key):
    task = tpaper.CLASSIFICATION[key]
    args = (task.model, task.batch, task.image)
    assert tresnet.flops_per_iter(*args) == jresnet.flops_per_iter(*args)
    assert tresnet.flops_per_iter(*args, 0.4) == jresnet.flops_per_iter(*args, 0.4)
    for _, jp, tp in POLICIES:
        assert tresnet.flops_per_iter(*args, policy=tp) == \
            jresnet.flops_per_iter(*args, policy=jp)


@pytest.mark.parametrize("key", sorted(jpaper.GENERATION))
@pytest.mark.parametrize("base", [16, 64])
def test_ddpm_flops_per_iter_at_every_paper_task(key, base):
    task = tpaper.GENERATION[key]
    args = (task.batch, task.image, base)
    assert tddpm.flops_per_iter(*args) == jddpm.flops_per_iter(*args)
    assert tddpm.flops_per_iter(*args, 0.4) == jddpm.flops_per_iter(*args, 0.4)
    for _, jp, tp in POLICIES:
        assert tddpm.flops_per_iter(*args, policy=tp) == jddpm.flops_per_iter(*args, policy=jp)
    assert list(tddpm.iter_conv_shapes(task.image, base)) == \
        list(jddpm.iter_conv_shapes(task.image, base))


def test_paper_configs_equal_field_by_field():
    fields = lambda c: [(f.name, f.type, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(tpaper.PaperTask) == fields(jpaper.PaperTask)
    for table in ("CLASSIFICATION", "GENERATION"):
        t, j = getattr(tpaper, table), getattr(jpaper, table)
        assert list(t) == list(j)
        for key in j:
            assert dataclasses.asdict(t[key]) == dataclasses.asdict(j[key]), key
    assert tpaper.GENERATION["celeba"].image == (3, 64, 64)
    assert tpaper.GENERATION["celeba"].timesteps == 1000


def test_train_classifier_prints_the_papers_ledger(capsys):
    """The classifier CLI returns and prints the example's ledger (dense
    against ssProp at the schedule-average rate) and a sparse step at the
    policy in force, each the JAX package's count."""
    import torch

    from repro_torch.launch import train_classifier as tc

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # XLA's pool and torch's contend in one process
    try:
        args = tc.build_parser().parse_args(
            ["--device", "cpu", "--batch", "2", "--image-size", "8", "--steps", "2",
             "--steps-per-epoch", "1", "--granularity", "block", "--block-size", "32",
             "--use-pallas", "--mode", "ssprop"])
        led = tc.run(args)["flops"]
        tc.print_ledger(led, args)
    finally:
        torch.set_num_threads(threads)
    jpol = dataclasses.replace(jpolicy.tpu_default(0.8), block_size=32, use_pallas=True)
    assert led["avg_rate"] == 0.4
    assert (led["dense"], led["nominal"]) == jresnet.flops_per_iter("resnet18", 2, (3, 8, 8), 0.4)
    assert led["policy"] == jresnet.flops_per_iter("resnet18", 2, (3, 8, 8), policy=jpol)[1]
    text = capsys.readouterr().out
    assert f"dense {led['dense'] / 1e9:.2f}B -> ssprop {led['nominal'] / 1e9:.2f}B" in text
    assert "(block, block 32, use_pallas True, real keep counts)" in text
