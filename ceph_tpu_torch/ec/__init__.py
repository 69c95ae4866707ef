"""Erasure coding: the plugin contract, coding matrices, the torch plugin and its registry."""

from ceph_tpu_torch.ec.interface import ErasureCodeInterface, ErasureCodeProfile
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry, factory
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.ec import matrix
