"""Model configurations (port of ``repro.configs``)."""
from .base import INPUT_SHAPES, MLAConfig, MoEConfig, ModelConfig, ShapeConfig, SSMConfig, TrainConfig, XLSTMConfig
from .registry import ALIASES, ARCH_IDS, canonical, get_config, smoke_config
