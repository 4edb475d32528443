"""Models of the port (the vision family of ``repro.models`` so far)."""

from repro_torch.models.vision import (TaskModel, accuracy,
                                       logistic_regression, mlp, resnet_tiny)

__all__ = ["TaskModel", "accuracy", "logistic_regression", "mlp",
           "resnet_tiny"]
