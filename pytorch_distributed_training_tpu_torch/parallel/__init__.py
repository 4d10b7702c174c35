"""Parallelism over ``torch.distributed`` process groups (port of the JAX
package's ``parallel/``): the (data, sequence), (data, model) and (data,
stage) layouts, the last grown by a model or a sequence axis
(:mod:`.mesh`), ring and Ulysses attention over the sequence
group (:mod:`.sequence`), Megatron tensor and expert parallelism over the
model group (:mod:`.tensor`), and the pipeline's stage layout and hops
(:mod:`.pipeline`)."""
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQUENCE_AXIS,
    STAGE_AXIS,
    PPLayout,
    SPLayout,
    TPLayout,
    resolve_seq_axis,
)
from .pipeline import StageExchange
from .sequence import GroupExchange, loopback, ring_attention, ulysses_attention
from .tensor import (
    TensorGroup,
    copy_to_model,
    gather_state_dict,
    param_role,
    reduce_from_model,
    shard_state_dict,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQUENCE_AXIS", "STAGE_AXIS", "GroupExchange", "PPLayout",
           "SPLayout", "StageExchange", "TPLayout", "TensorGroup", "copy_to_model",
           "gather_state_dict", "loopback", "param_role", "reduce_from_model",
           "resolve_seq_axis", "ring_attention", "shard_state_dict", "ulysses_attention"]
