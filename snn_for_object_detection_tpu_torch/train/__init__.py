"""Evaluation loop and COCO mAP."""
