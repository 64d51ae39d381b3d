"""PyTorch port: the SSD ops (``ops/contrib_ops.py``: MultiBoxPrior,
MultiBoxTarget, MultiBoxDetection, box_nms) and ``L2Normalization`` and
``LRN`` (``ops/nn.py``) against the JAX package's ops on the same numpy
inputs.

- The prior bit for bit, at SSD300's six maps and over other sizes,
  ratios, steps, offsets and clip settings.
- The target: classes and masks equal, offsets at rtol 2e-5 / atol
  1e-6, with pad rows, two objects claiming one anchor (the later one
  wins in both packages), mining on and off and
  ``minimum_negative_samples``.
- The detection (``force_suppress``, ``nms_topk``, ``background_id``,
  ``clip``) and ``box_nms`` (formats, ``id_index``, ``background_id``,
  ``topk``, ``force_suppress``): every row's id equal, scores and boxes
  at rtol 2e-5 / atol 1e-6.
- The prior and the target give zero gradients (so does the JAX
  package's vjp).
- ``L2Normalization``'s three modes and ``LRN``, forward and backward
  (``jax.vjp``) at rtol 2e-5 / atol 1e-6; an f16 graph holding either
  raises naming ROADMAP A.6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import get_op

RTOL, ATOL = 2e-5, 1e-6


def jop(name, **kw):
    """The JAX op under ``jax.jit`` with its attributes bound (one
    compile a case instead of one a primitive)."""
    fn = jget_op(name).fn
    return jax.jit(lambda *a: fn(*a, **kw))


# SSD300's maps: (size, sizes, ratios, step in pixels of 300)
SSD300_PRIORS = [
    (38, (.1, .141), (1, 2, .5), 8),
    (19, (.2, .272), (1, 2, .5, 3, 1 / 3), 16),
    (10, (.37, .447), (1, 2, .5, 3, 1 / 3), 32),
    (5, (.54, .619), (1, 2, .5, 3, 1 / 3), 64),
    (3, (.71, .79), (1, 2, .5), 100),
    (1, (.88, .961), (1, 2, .5), 300)]
PRIOR_CASES = {
    "ssd300_%d" % m: dict(shape=(1, 2, m, m), sizes=s, ratios=r,
                          steps=(st / 300, st / 300))
    for m, s, r, st in SSD300_PRIORS}
PRIOR_CASES.update({
    "default": dict(shape=(2, 3, 4, 6)),
    "clip_offsets": dict(shape=(1, 1, 5, 7), sizes=(.3, .7, .95),
                         ratios=(1, 3), clip=True, offsets=(0.25, 0.75)),
    "steps_rect": dict(shape=(1, 1, 6, 3), sizes=(.2,), ratios=(2, .5, 1),
                       steps=(0.1, 0.3)),
    "scalar_size": dict(shape=(1, 1, 2, 2), sizes=0.5, ratios=2.0,
                        clip=True),
})


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_is_bit_equal(case):
    kw = dict(PRIOR_CASES[case])
    x = np.zeros(kw.pop("shape"), np.float32)
    want = np.asarray(jop("MultiBoxPrior", **kw)(jnp.asarray(x)))
    got = get_op("MultiBoxPrior").fn(torch.from_numpy(x), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _anchors(m=8, sizes=(.2, .35), ratios=(1, 2, .5)):
    x = torch.zeros(1, 1, m, m)
    return get_op("MultiBoxPrior").fn(x, sizes=sizes, ratios=ratios).numpy()


def _labels(rng, B, M, C, pad=True):
    """``B`` images of 1..M (all M without ``pad``) boxes of ``C`` classes,
    -1 rows after them."""
    lab = np.full((B, M, 5), -1, np.float32)
    for b in range(B):
        for m in range(rng.randint(1, M + 1) if pad else M):
            x0, y0 = rng.rand(2) * 0.7
            w, h = rng.rand(2) * 0.3 + 0.05
            lab[b, m] = [rng.randint(C), x0, y0, x0 + w, y0 + h]
    return lab


TARGET_CASES = {
    "no_mining": dict(),
    "mining": dict(negative_mining_ratio=3.0),
    "mining_min_negatives": dict(negative_mining_ratio=3.0,
                                 minimum_negative_samples=40,
                                 negative_mining_thresh=0.4),
    "threshold_ignore": dict(overlap_threshold=0.3, ignore_label=-2.0,
                             negative_mining_ratio=1.0,
                             variances=(0.2, 0.2, 0.1, 0.1)),
}


def _target(lab, cls, anc, kw):
    want = jop("MultiBoxTarget", **kw)(jnp.asarray(anc), jnp.asarray(lab),
                                       jnp.asarray(cls))
    got = get_op("MultiBoxTarget").fn(torch.from_numpy(anc),
                                      torch.from_numpy(lab),
                                      torch.from_numpy(cls), **kw)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_target_matches_jax(case):
    rng = np.random.RandomState(1)
    anc = _anchors()
    B, M, C = 4, 6, 5
    lab = _labels(rng, B, M, C - 1)
    cls = rng.randn(B, C, anc.shape[1]).astype(np.float32)
    (jl, jm, jc), (pl, pm, pc) = _target(lab, cls, anc, TARGET_CASES[case])
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert (pc > 0).any() and (pc == 0).any()
    if "negative_mining_ratio" in TARGET_CASES[case]:
        assert (pc == TARGET_CASES[case].get("ignore_label", -1.0)).any()


def test_target_duplicate_claim_later_object_wins():
    """Two objects whose best anchor is the same: the JAX package's
    scatter keeps the later object, the port's ``amax`` reduction
    too."""
    anc = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1],
                     [.5, 0, 1, .5]]], np.float32)
    lab = np.array([[[0, .1, .1, .4, .4], [1, .1, .1, .4, .4],
                     [2, .6, .6, .9, .9], [-1, 0, 0, 0, 0]]], np.float32)
    cls = np.zeros((1, 4, 4), np.float32)
    for order in ((0, 1, 2, 3), (1, 0, 2, 3)):
        kw = dict(overlap_threshold=0.99)
        (jl, jm, jc), (pl, pm, pc) = _target(lab[:, order], cls, anc, kw)
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
        # anchor 0 takes the class of the later of the two objects
        assert pc[0, 0] == lab[0, order[1], 0] + 1


DETECTION_CASES = {
    "default": dict(),
    "force_suppress": dict(force_suppress=True, nms_threshold=0.3),
    "nms_topk": dict(nms_topk=20),
    "background_1_noclip": dict(background_id=1, clip=False, threshold=0.3),
}


@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_detection_matches_jax(case):
    rng = np.random.RandomState(2)
    anc = _anchors()
    B, C, A = 3, 4, anc.shape[1]
    prob = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.randn(B, C, A).astype(np.float32) * 2), axis=1))
    loc = (rng.randn(B, A * 4) * 0.5).astype(np.float32)
    kw = DETECTION_CASES[case]
    want = np.asarray(jop("MultiBoxDetection", **kw)(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anc)))
    got = get_op("MultiBoxDetection").fn(torch.tensor(prob),
                                         torch.from_numpy(loc),
                                         torch.from_numpy(anc), **kw).numpy()
    assert got.shape == want.shape == (B, A, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL)
    kept = got[..., 0] >= 0
    assert kept.any() and (~kept).any()


NMS_CASES = {
    "default": dict(),
    "id_index": dict(id_index=0),
    "background_topk": dict(id_index=0, background_id=1, topk=10),
    "force_suppress": dict(id_index=0, force_suppress=True,
                           overlap_thresh=0.3),
    "center_to_corner": dict(in_format="center", out_format="corner"),
    "corner_to_center": dict(out_format="center", valid_thresh=0.4),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms_matches_jax(case):
    rng = np.random.RandomState(3)
    d = rng.rand(2, 3, 30, 6).astype(np.float32)
    d[..., 0] = rng.randint(0, 3, (2, 3, 30))
    d[..., 4:] += d[..., 2:4]
    kw = NMS_CASES[case]
    want = np.asarray(jop("box_nms", **kw)(jnp.asarray(d)))
    got = get_op("box_nms").fn(torch.from_numpy(d), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[..., 1] == -1).any() and (got[..., 1] > 0).any()


def test_box_nms_passes_the_kept_rows_gradient():
    """Rows reach the output through a gather: their gradient comes back
    to the input rows (the JAX op's vjp), the scores of suppressed rows
    none."""
    rng = np.random.RandomState(4)
    d = rng.rand(1, 12, 6).astype(np.float32)
    d[..., 4:] += d[..., 2:4]
    g = rng.randn(1, 12, 6).astype(np.float32)
    _, vjp = jax.vjp(jop("box_nms", id_index=0), jnp.asarray(d))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(d).requires_grad_()
    get_op("box_nms").fn(t, id_index=0).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_prior_and_target_give_zero_gradients():
    """Through a bound graph: the feature map feeding the prior and the
    class predictions feeding the target take zero gradients from them
    (the JAX package's vjp of its target with respect to the
    predictions is zero too)."""
    rng = np.random.RandomState(5)
    anc = _anchors(m=4, sizes=(.4,), ratios=(1,))
    lab = _labels(rng, 2, 3, 2)
    cls = rng.randn(2, 3, anc.shape[1]).astype(np.float32)
    target = jop("MultiBoxTarget", negative_mining_ratio=3.0)
    _, vjp = jax.vjp(lambda c: target(jnp.asarray(anc), jnp.asarray(lab), c),
                     jnp.asarray(cls))
    outs = [np.ones((2, anc.shape[1] * 4), np.float32)] * 2 \
        + [np.ones((2, anc.shape[1]), np.float32)]
    assert not np.asarray(vjp(tuple(jnp.asarray(o) for o in outs))[0]).any()

    data, label = mx.sym.Variable("data"), mx.sym.Variable("label")
    pred = mx.sym.Variable("pred")
    anchors = mx.sym.MultiBoxPrior(data, sizes=(.4,), ratios=(1,))
    tgt = mx.sym.MultiBoxTarget(anchors, label, pred,
                                negative_mining_ratio=3.0)
    net = mx.sym.Group([anchors, tgt[0], tgt[1], tgt[2]])
    exe = net.simple_bind(ctx=mx.cpu(), grad_req="write", data=(2, 1, 4, 4),
                          label=(2, 3, 5), pred=cls.shape)
    cpu = mx.cpu()
    exe.forward(is_train=True,
                data=mx.nd.array(rng.rand(2, 1, 4, 4), ctx=cpu),
                label=mx.nd.array(lab, ctx=cpu),
                pred=mx.nd.array(cls, ctx=cpu))
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(), anc)
    exe.backward([mx.nd.ones(o.shape, ctx=cpu) for o in exe.outputs])
    for name in ("data", "pred", "label"):
        assert not exe.grad_dict[name].asnumpy().any(), name


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_matches_jax(mode):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    kw = dict(mode=mode, eps=1e-6)
    want, vjp = jax.vjp(jop("L2Normalization", **kw), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = get_op("L2Normalization").fn(t, **kw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(nsize=5), dict(nsize=3, alpha=1e-2,
                                                     beta=0.5, knorm=1.0)],
                         ids=["alexnet", "nsize3"])
def test_lrn_matches_jax(kw):
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 7, 4, 5) * 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(jop("LRN", **kw), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = get_op("LRN").fn(t, **kw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["L2Normalization", "LRN"])
def test_float16_graph_raises_naming_a6(op):
    data = mx.sym.Variable("data")
    out = getattr(mx.sym, op)(data, **({"nsize": 3} if op == "LRN" else {}))
    with pytest.raises(MXNetError, match="A.6"):
        out.simple_bind(ctx=mx.cpu(), type_dict={"data": "float16"},
                        grad_req="write", data=(1, 3, 4, 4))


def test_registered_names_match_jax():
    from mxnet_tpu.ops import registry as jreg
    names = ["_contrib_MultiBoxPrior", "MultiBoxPrior",
             "_contrib_MultiBoxTarget", "MultiBoxTarget",
             "_contrib_MultiBoxDetection", "MultiBoxDetection",
             "_contrib_box_nms", "box_nms", "L2Normalization", "LRN"]
    for n in names:
        assert n in jreg.list_ops()
        assert get_op(n) is not None
    assert get_op("MultiBoxTarget").visible_out_count({}) == 3
