from .ops import paged_attention, paged_attention_hot_slots
from .ref import paged_attention_hot_slots_ref, paged_attention_ref

__all__ = ["paged_attention", "paged_attention_hot_slots",
           "paged_attention_ref", "paged_attention_hot_slots_ref"]
