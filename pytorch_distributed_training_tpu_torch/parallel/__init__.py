"""Parallelism over ``torch.distributed`` process groups (port of the JAX
package's ``parallel/``): the (data, sequence) layout (:mod:`.mesh`) and
ring and Ulysses attention over the sequence group (:mod:`.sequence`)."""
from .mesh import DATA_AXIS, SEQUENCE_AXIS, SPLayout, resolve_seq_axis
from .sequence import GroupExchange, loopback, ring_attention, ulysses_attention

__all__ = ["DATA_AXIS", "SEQUENCE_AXIS", "GroupExchange", "SPLayout", "loopback",
           "resolve_seq_axis", "ring_attention", "ulysses_attention"]
