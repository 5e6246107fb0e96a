"""The port's test files run torch's CPU ops on one thread each.

The tier-1 suite runs six workers on one host; a worker's torch takes a
thread a core by default, so six of them oversubscribe the cores several
times over and every test waits on the others. Each ``tests/test_torch_*``
module imports :func:`few_torch_threads` (a module fixture, autouse), which
caps the worker's torch threads while that module's tests run and puts the
count back after. One thread, not two: on a loaded host two threads gave
the flash backward's plain version a second set of fp32 roundings now and
then (``test_torch_attention_bwd.py``'s dq 4.6e-5 off JAX's where 1.1e-6 is
usual); a single thread's order does not vary."""

import pytest
import torch

TORCH_THREADS = 1


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)
