"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

- :mod:`repro_torch.kernels.packed_sweep` — the fused tile sweep
  (``csrc/packed_sweep.cu``), counterpart of the JAX package's Pallas
  ``repro.kernels.packed_sweep``.
- :mod:`repro_torch.kernels.dsss_spmv` — the sub-shard ToHub update
  (``csrc/dsss_spmv.cu``), counterpart of ``repro.kernels.dsss_spmv``,
  per sub-shard or for a whole pass; :mod:`repro_torch.kernels.ops` stages
  its operands.
- :mod:`repro_torch.kernels.flash_attention` — online-softmax attention
  (``csrc/flash_attention.cu``), counterpart of
  ``repro.kernels.flash_attention``; :func:`repro_torch.kernels.ops.attention`
  is the models' entry, re-exported here as :func:`attention` (the kernel
  function itself is not: its name is the module's).

Kernels are built from ``csrc/`` at first use (:mod:`._build`); importing
this package builds nothing.
"""
from repro_torch.kernels.dsss_spmv import (
    dsss_spmv_block_partials,
    subshard_update,
    subshard_update_pass,
)
from repro_torch.kernels.ops import attention, prepare_subshard_operands
from repro_torch.kernels.packed_sweep import (
    packed_sweep_update,
    packed_sweep_update_ref,
    packed_sweep_update_select,
    prepare_packed_tiles,
)

__all__ = [
    "attention",
    "prepare_subshard_operands",
    "packed_sweep_update",
    "packed_sweep_update_select",
    "packed_sweep_update_ref",
    "prepare_packed_tiles",
    "dsss_spmv_block_partials",
    "subshard_update",
    "subshard_update_pass",
]
