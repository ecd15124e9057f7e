"""Synthetic datasets for the port (copy of ``icl/testing``)."""
from icl_torch.testing.synth import SynthConfig, generate_dataset

__all__ = ["SynthConfig", "generate_dataset"]
