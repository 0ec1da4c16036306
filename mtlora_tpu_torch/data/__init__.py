"""The MTL data pipeline: PASCAL-Context / NYUD datasets and the synthetic
set, the host-side transforms, the task configuration and the sharded
batch loader (counterpart of ``mtlora_tpu/data``)."""

from mtlora_tpu_torch.data.task_config import get_tasks_config  # noqa: F401
