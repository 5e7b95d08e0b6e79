"""``python -m snn_for_object_detection_tpu_torch {fit,validate,test,predict}``."""

from snn_for_object_detection_tpu_torch.cli import main

if __name__ == "__main__":
    main()
