"""Utilities: the JAX -> port weight bridge, reference state dict import."""

from seld_tpu_torch.utils.torch_import import import_reference_state_dict  # noqa: F401
