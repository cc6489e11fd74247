# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""An autouse fixture for the port's test files: PyTorch runs on one
intra-op thread while a file's tests run, and on its former count after.

The suite runs one process per core (``pytest -n``). Further PyTorch
threads in each process only contend for those cores, and their
spin-waits cost more than they save at the tests' small sizes. Import the
fixture into a test module to apply it there::

    from _torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
