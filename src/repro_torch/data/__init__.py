"""Synthetic data streams (numpy, host side), the neighbour sampler and the
input pipeline."""

from repro_torch.data.pipeline import PrefetchPipeline  # noqa: F401
from repro_torch.data.graph_sampler import NeighborSampler  # noqa: F401
