"""Models of the port: the vision family of ``repro.models``, and the
dense, moe, mla, rwkv and hybrid transformer families in ``layers``,
``attention``, ``moe``, ``mla``, ``transformer`` and ``model`` (import
those from their modules). The two recurrent cores, ``rwkv`` (RWKV-6's
time and channel mix) and ``ssm`` (Hymba's selective state-space
branch), are exported as modules."""

from repro_torch.models import rwkv, ssm
from repro_torch.models.vision import (TaskModel, accuracy,
                                       logistic_regression, mlp, resnet_tiny)

__all__ = ["TaskModel", "accuracy", "logistic_regression", "mlp",
           "resnet_tiny", "rwkv", "ssm"]
