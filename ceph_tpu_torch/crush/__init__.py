"""CRUSH placement: map model, hashes, rule VM, kernel, scalar spec."""

from ceph_tpu_torch.crush.types import (
    Bucket, Rule, RuleStep, Tunables, CrushMap,
    ALG_UNIFORM, ALG_LIST, ALG_TREE, ALG_STRAW, ALG_STRAW2,
    OP_TAKE, OP_CHOOSE_FIRSTN, OP_CHOOSE_INDEP, OP_CHOOSELEAF_FIRSTN,
    OP_CHOOSELEAF_INDEP, OP_EMIT,
    ITEM_NONE, ITEM_UNDEF,
)
from ceph_tpu_torch.crush import builder, hash as crush_hash, mapper, mapper_ref
from ceph_tpu_torch.crush.mapper import Mapper
from ceph_tpu_torch.crush.tensors import pack_map
