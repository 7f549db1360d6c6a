from goicp_tpu_torch.core.config import Config, Mode
from goicp_tpu_torch.core.logging import Logger, LogLevel, get_logger
from goicp_tpu_torch.core.types import Bounds, CubeBatch, RigidTransform

__all__ = [
    "Config",
    "Mode",
    "Logger",
    "LogLevel",
    "get_logger",
    "RigidTransform",
    "CubeBatch",
    "Bounds",
]
