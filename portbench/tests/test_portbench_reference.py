"""The plain reference against independent computations at small sizes
on the CPU: float64 numpy loops of the same equations, brute-force
assignment and NMS, torch's own Adamax, and the program's plain path."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.lib import inputs
from portbench.reference import detection as D
from portbench.reference import tiny_yolo as R
from portbench.reference import train as RT


def _lif64(x, v, i):
    v_dec = v + 0.1 * ((0.0 - v) + i)
    i_dec = i - 0.2 * i
    z = (v_dec - 1.0 > 0).astype(np.float64)
    return z, np.where(z > 0, 0.0, v_dec), i_dec + x


def _li64(x, v, i):
    i = i + x
    v_new = v + 0.1 * ((0.0 - v) + i)
    return v_new, v_new, i - 0.2 * i


@pytest.mark.parametrize("kind", ["lif", "li"])
def test_cells_against_float64(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (200, 16)).astype(np.float32)
    v = np.zeros(16, np.float32)
    i = np.zeros(16, np.float32)
    v64, i64 = v.astype(np.float64), i.astype(np.float64)
    fn, fn64 = (R.lif, _lif64) if kind == "lif" else (R.li, _li64)
    for t in range(200):
        z, vt, it = fn(torch.from_numpy(x[t]), torch.from_numpy(v),
                       torch.from_numpy(i))
        z64, v64n, i64n = fn64(x[t].astype(np.float64), v64, i64)
        # the float32 trajectory stays within rounding of the exact one
        # while the spikes agree; restart the exact one from it so a
        # spike at the threshold cannot carry a difference on
        np.testing.assert_allclose(it.numpy(), i64n, rtol=1e-5, atol=1e-5)
        if kind == "li":
            np.testing.assert_allclose(z.numpy(), z64, rtol=1e-5, atol=1e-5)
        else:
            near = np.abs((v64 + 0.1 * (-v64 + i64)) - 1.0) < 1e-4
            assert np.array_equal(z.numpy()[~near], z64[~near])
        v, i = vt.numpy(), it.numpy()
        v64, i64 = v.astype(np.float64), i.astype(np.float64)


def test_superspike_gradient():
    x = torch.tensor([-0.5, 0.0, 0.25, 2.0], requires_grad=True)
    z = R._SuperSpike.apply(x)
    assert z.tolist() == [0.0, 0.0, 1.0, 1.0]
    (g,) = torch.autograd.grad(z.sum(), x)
    want = 1.0 / (100.0 * x.detach().abs() + 1.0) ** 2
    assert torch.allclose(g, want)


def test_tf32_rounding():
    one = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                        1.0 + 3 * 2 ** -11, float("inf")])
    got = R.to_tf32(one).tolist()
    assert got == [1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                   1.0 + 2 * 2 ** -10, float("inf")]


def test_conv_against_float64():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    got = R._conv2d(torch.from_numpy(x), torch.from_numpy(w), 3, 2, False)
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ho, wo = (7 + 2 - 3) // 2 + 1, (9 + 2 - 3) // 2 + 1
    want = np.zeros((2, ho, wo, 4))
    for a in range(ho):
        for b in range(wo):
            patch = xp[:, 2 * a:2 * a + 3, 2 * b:2 * b + 3, :]
            want[:, a, b, :] = np.einsum("nhwc,ochw->no", patch, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_anchors_against_the_formula():
    taps = [(8, (2, 3)), (8, (1, 2))]
    got = D.anchors(taps).numpy()
    sizes = [0.08 + k * 0.67 / 6 for k in range(6)]
    rows = []
    for s, (_, (h, w)) in enumerate(taps):
        for y in range(h):
            for x in range(w):
                for r in (0.5, 1.0, 2.0):
                    for size in sizes[3 * s:3 * s + 3]:
                        bw, bh = size * r * h / w, size / r * w / h
                        cx, cy = (x + 0.5) / w, (y + 0.5) / h
                        rows.append([cx - bw / 2, cy - bh / 2,
                                     cx + bw / 2, cy + bh / 2])
    np.testing.assert_allclose(got, np.array(rows), atol=1e-6)


def _brute_assign(anc, boxes, thr):
    iou = D.iou(anc, boxes).numpy().astype(np.float64)
    amap = np.where(iou.max(1) >= thr, iou.argmax(1), -1)
    left = iou.copy()
    for _ in range(boxes.shape[0]):
        a, b = np.unravel_index(np.argmax(left), left.shape)
        if left[a, b] < 0:
            break
        amap[a] = b
        left[a, :] = -1
        left[:, b] = -1
    return amap


def test_assignment_against_brute_force():
    anc = D.anchors([(8, (4, 5))])
    boxes = torch.tensor([[0.1, 0.1, 0.4, 0.5], [0.5, 0.2, 0.9, 0.6],
                          [0.0, 0.7, 0.2, 0.95]])
    got = D.assign(anc, boxes, 0.4).numpy()
    assert np.array_equal(got, _brute_assign(anc, boxes, 0.4))
    assert set(got[got >= 0]) == {0, 1, 2}


def test_loss_against_a_numpy_computation():
    rng = np.random.default_rng(2)
    anc = D.anchors([(8, (3, 4))])
    a = anc.shape[0]
    cls = torch.from_numpy(rng.normal(size=(2, a, 3)).astype(np.float32))
    box = torch.from_numpy(rng.normal(size=(2, a, 4)).astype(np.float32))
    labels = inputs.labels(1, 2, 6, 2, 9, "cpu")[0]
    got = float(D.loss(cls, box, anc, labels, 0.4, 0.04))
    off, mask, cl = (t.numpy().astype(np.float64)
                     for t in D.targets(anc, labels, 0.4))
    c = cls.numpy().astype(np.float64).reshape(-1, 3)
    logp = c - np.log(np.exp(c).sum(1, keepdims=True))
    ce = -logp[np.arange(len(c)), cl.reshape(-1).astype(int)]
    pos = cl.reshape(-1) > 0
    want = (ce[pos].sum() / max(pos.sum(), 1) * 0.04
            + ce[~pos].sum() / max((~pos).sum(), 1) * 0.96
            + np.abs(box.numpy() * mask - off * mask).mean())
    assert got == pytest.approx(want, rel=1e-5)


def _brute_nms(probs, boxes, k, thr):
    conf = probs.max(1).values.tolist()
    cid = (probs.argmax(1) - 1).tolist()
    order = sorted(range(len(conf)), key=lambda j: (
        -(conf[j] if cid[j] >= 0 else conf[j] - 2.0), j))[:k]
    kept = []
    for j in order:
        if cid[j] < 0:
            continue
        if all(cid[q] != cid[j] or float(D.iou(boxes[[q]], boxes[[j]])[0, 0])
               <= thr for q in kept):
            kept.append(j)
    return order, kept


def test_detect_against_brute_force():
    rng = np.random.default_rng(3)
    anc = D.anchors([(8, (4, 5))])
    a = anc.shape[0]
    cls = torch.from_numpy(rng.normal(size=(1, a, 3)).astype(np.float32) * 3)
    box = torch.from_numpy(rng.normal(size=(1, a, 4)).astype(np.float32))
    got = D.detect(cls, box, anc)[0]
    probs = torch.softmax(cls[0], -1)
    boxes = D.decode(anc, box[0])
    order, kept = _brute_nms(probs, boxes, min(300, a), 0.1)
    assert got.shape == (min(300, a), 6)
    kept_rows = [r for r, j in enumerate(order) if j in kept
                 and probs[j].max() >= D.POS_THRESHOLD]
    assert (got[:, 0] >= 0).nonzero().flatten().tolist() == kept_rows
    np.testing.assert_allclose(got[:, 2:].numpy(), boxes[order].numpy())


def test_adamax_against_torch():
    rng = np.random.default_rng(4)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((3, 4), (5,))]
    mine = [x.clone() for x in leaves]
    theirs = [torch.nn.Parameter(x.clone()) for x in leaves]
    opt = torch.optim.Adamax(theirs, lr=1e-3)
    ref = RT.Adamax(mine, 1e-3)
    for step in range(3):
        grads = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
                 for x in leaves]
        ref.step(mine, grads)
        for p, g in zip(theirs, grads):
            p.grad = g
        opt.step()
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b.detach(), rtol=1e-6, atol=1e-7)


def test_forward_agrees_with_the_programs_plain_path():
    """At 32x40 the reference's train forward and loss equal the
    program's on the CPU (its kernels' plain versions) to rounding."""
    from portbench.lib import port

    cfg = {"num_classes": 2, "in_hw": [32, 40], "loss_ratio": 0.04,
           "time_window": 3, "iou_threshold": 0.4, "learning_rate": 1e-3,
           "dtype": "float32", "state_dtype": "float32"}
    net = R.Net(2, (32, 40))
    weights = inputs.weights(net.weight_shapes(), 5, "cpu")
    scales = inputs.scales(net.norms, "cpu")
    model, _ = port.build_model(cfg, weights, scales, "cpu")
    X = inputs.frames(1, (8, 2, 32, 40, 2), 5, "cpu")[0]
    L = inputs.labels(1, 2, 8, 2, 5, "cpu")[0]
    anc = D.anchors(net.taps)
    assert torch.equal(anc, model.anchors)
    for start in (0, 2):
        preds, _ = model.forward(X, start_step=start, train=True)
        want = model.loss(preds, L)
        cls, box = RT.forward(net, R.Params(weights, scales), X, start, True)
        got = D.loss(cls, box, anc, L, 0.4, 0.04)
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(cls.detach().numpy(),
                                   preds[0].detach().numpy(), atol=1e-4)
