"""The port's host and decode ops against the JAX package, on the CPU.

Same seeded numpy inputs into both. Class ids, masks and assignments
must be equal. Boxes and confidences agree within rtol 1e-6: ``log``,
``exp`` and softmax come from different math libraries (XLA's vs
PyTorch's), which round the last bit differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_for_object_detection_tpu.ops import anchors as janchors
from snn_for_object_detection_tpu.ops import boxes as jboxes
from snn_for_object_detection_tpu.ops import matching as jmatching
from snn_for_object_detection_tpu.ops import nms as jnms
from snn_for_object_detection_tpu.train import metrics as jmetrics
from snn_for_object_detection_tpu_torch.ops import anchors, boxes, matching
from snn_for_object_detection_tpu_torch.ops import nms
from snn_for_object_detection_tpu_torch.train import metrics

torch.set_num_threads(1)
RTOL = 1e-6


def _boxes(rng, n):
    xy = rng.random((n, 2)).astype(np.float32) * 0.8
    wh = rng.random((n, 2)).astype(np.float32) * 0.3 + 0.02
    return np.concatenate([xy, xy + wh], axis=1)


def _labels(rng, b, n, n_real):
    lab = np.full((b, n, 5), -1.0, np.float32)
    for i in range(b):
        k = n_real[i]
        lab[i, :k, 0] = rng.integers(0, 2, k)
        lab[i, :k, 1:] = _boxes(rng, k)
    return lab


@pytest.fixture(scope="module")
def anchor_grid():
    sizes = janchors.default_scale_sizes(2)
    a = np.concatenate([
        janchors.generate_anchors(6, 8, sizes[0], janchors.DEFAULT_RATIOS),
        janchors.generate_anchors(3, 4, sizes[1], janchors.DEFAULT_RATIOS),
    ])
    return a


def test_anchor_copy_is_identical():
    for h, w, n in ((30, 38, 3), (8, 10, 3), (5, 7, 1)):
        sizes = janchors.default_scale_sizes(n)
        np.testing.assert_array_equal(anchors.default_scale_sizes(n), sizes)
        np.testing.assert_array_equal(
            anchors.generate_anchors(h, w, sizes[-1], anchors.DEFAULT_RATIOS),
            janchors.generate_anchors(h, w, sizes[-1],
                                      janchors.DEFAULT_RATIOS),
        )


def test_box_geometry_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 25)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        boxes.corner_to_center(ta).numpy(), jboxes.corner_to_center(a))
    np.testing.assert_array_equal(
        boxes.center_to_corner(ta).numpy(), jboxes.center_to_corner(a))
    np.testing.assert_allclose(
        boxes.box_iou(ta, tb).numpy(), jboxes.box_iou(a, b), rtol=RTOL)
    off = boxes.encode_offsets(ta, torch.from_numpy(a[::-1].copy()))
    np.testing.assert_allclose(
        off.numpy(), jboxes.encode_offsets(a, a[::-1]), rtol=RTOL,
        atol=1e-6)
    np.testing.assert_allclose(
        boxes.decode_offsets(ta, off).numpy(),
        jboxes.decode_offsets(a, np.asarray(off)), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("threshold", [0.4, 0.5])
def test_match_targets_matches_jax(anchor_grid, threshold):
    rng = np.random.default_rng(1)
    labels = _labels(rng, 3, 6, [4, 0, 6])
    j_off, j_mask, j_cls = jmatching.match_targets(
        jnp.asarray(anchor_grid), jnp.asarray(labels), threshold)
    t_off, t_mask, t_cls = matching.match_targets(
        torch.from_numpy(anchor_grid), torch.from_numpy(labels), threshold)
    np.testing.assert_array_equal(t_cls.numpy(), np.asarray(j_cls))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_off.numpy(), np.asarray(j_off),
                               rtol=RTOL, atol=1e-5)
    assert int((t_cls > 0).sum()) >= 10  # real assignments happened


def test_multibox_detection_matches_jax(anchor_grid):
    rng = np.random.default_rng(2)
    b, a = 2, anchor_grid.shape[0]
    logits = rng.standard_normal((b, a, 3)).astype(np.float32) * 2.0
    offsets = rng.standard_normal((b, a, 4)).astype(np.float32) * 0.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for max_out in (50, 1000):  # fewer and more slots than anchors
        want = np.asarray(jnms.multibox_detection(
            jnp.asarray(probs), jnp.asarray(offsets),
            jnp.asarray(anchor_grid), max_out=max_out,
        ))
        got = nms.multibox_detection(
            torch.from_numpy(probs), torch.from_numpy(offsets),
            torch.from_numpy(anchor_grid), max_out=max_out,
        ).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                                   atol=1e-7)
        assert (got[..., 0] >= 0).sum() > 5  # detections survive NMS


def test_mean_average_precision_copy_matches():
    rng = np.random.default_rng(4)
    dets = np.zeros((3, 20, 6), np.float32)
    dets[..., 0] = rng.integers(-1, 2, (3, 20))
    dets[..., 1] = rng.random((3, 20))
    dets[..., 2:] = _boxes(rng, 60).reshape(3, 20, 4)
    labels = _labels(rng, 3, 5, [3, 5, 1])
    # a few detections on the ground truth so AP is not 0
    dets[:, :2, 0] = labels[:, :2, 0]
    dets[:, :2, 2:] = labels[:, :2, 1:] + 0.01
    results = []
    for mod in (metrics, jmetrics):
        m = mod.MeanAveragePrecision()
        m.update(*mod.detections_to_map_inputs(dets, labels))
        results.append(m.compute())
    assert results[0] == results[1]
    assert results[0]["map_50"] > 0
