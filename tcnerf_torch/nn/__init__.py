from .blocks import ResNetMLPBlock, RenderReadout, Readout  # noqa: F401
from .mlp import MVResNetMLPEmbedding, ResNetMLPEmbedding  # noqa: F401
from .grasp_readout import GraspReadout  # noqa: F401
