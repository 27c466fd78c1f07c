from gaussian_splatterer_tpu_torch.train.densify import DensifyParams, densify  # noqa: F401
from gaussian_splatterer_tpu_torch.train.schedule import auto_train  # noqa: F401
from gaussian_splatterer_tpu_torch.train.trainer import (  # noqa: F401
    CameraBatch,
    LearningRates,
    Trainer,
    TrainMetrics,
    fused_kw_from_runtime,
    make_train_step,
    randomize_rig_rotations,
)
