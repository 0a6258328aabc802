"""Parallelism: sequence (context) parallelism over a ring of token shards."""

from .sequence import (LocalRing, ProcessGroupRing, create_seq_groups,
                       dit_sequence_parallel_forward, sequence_parallel_stack)

__all__ = ["LocalRing", "ProcessGroupRing", "create_seq_groups",
           "dit_sequence_parallel_forward", "sequence_parallel_stack"]
