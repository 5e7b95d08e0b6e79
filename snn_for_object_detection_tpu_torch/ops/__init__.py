"""Compute ops: neuron cells, CUDA kernels, boxes, anchors, matching, NMS."""
