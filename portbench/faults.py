"""Faults planted in the program under test, for reading what each does to
the numbers `correct` compares (calibrate.py, the CPU tests). The
benchmark's own runs plant none.

Each is a context manager that breaks one layer of the timed path while it
is open."""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock


@contextmanager
def topk_indices_rolled():
    """The sampler's top-k hands back its k best values with the indices
    rolled by one place: the draw picks a value and returns the token of the
    next candidate (the best value maps to the k-th best token)."""
    from coati_tpu_torch.ops import sampling

    real = sampling.top_k_candidates

    def rolled(logits, k):
        vals, idxs = real(logits, k)
        return vals, idxs.roll(1, dims=-1)

    with mock.patch.object(sampling, "top_k_candidates", rolled):
        yield


@contextmanager
def half_inverse_temperature():
    """The sampler draws at half the inverse temperature it is asked for."""
    from coati_tpu_torch.models import sampler

    real = sampler.sample_top_k

    def half(generator, logits, k, inv_temp, top_p=None):
        return real(generator, logits, k, inv_temp / 2, top_p=top_p)

    with mock.patch.object(sampler, "sample_top_k", half):
        yield


# the faults a round trip's top-k requests can have, by the name calibrate.py prints
SAMPLER = {"topk_indices_rolled": topk_indices_rolled,
           "half_inverse_temperature": half_inverse_temperature}
