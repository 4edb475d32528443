"""Models of the port: the vision family of ``repro.models``, and the
dense, moe and mla transformer families in ``layers``, ``attention``,
``moe``, ``mla``, ``transformer`` and ``model`` (import those from their
modules)."""

from repro_torch.models.vision import (TaskModel, accuracy,
                                       logistic_regression, mlp, resnet_tiny)

__all__ = ["TaskModel", "accuracy", "logistic_regression", "mlp",
           "resnet_tiny"]
