"""One torch intra-op thread in a test process of the port and in the
rank processes it spawns (they inherit ``OMP_NUM_THREADS``).

The port's CPU tests run at reduced sizes, where torch's default of one
thread per core only contends with the other test workers: six workers
of eight threads each on eight cores made the six largest port files
take 3.0x the worker time they take at one thread each (1,214.6
against 401.1 s, junit of the tier-1 command on an 8-core host).  Imported by
every ``tests/test_torch_*.py`` for that effect alone; XLA's CPU thread
pool does not read ``OMP_NUM_THREADS``.

The gloo ranks a test spawns set their own thread count
(``launch/ranks.run_ranks``); ``MKL_DYNAMIC`` off holds MKL to it, where
by default MKL may take fewer threads on a loaded host and so sum a
product in another order, and tests that hold two multi-rank runs to
the same bits would then differ in the last place."""
import os

os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_DYNAMIC"] = "FALSE"

import torch  # noqa: E402

torch.set_num_threads(1)
