import os
import sys

# One host thread for the CPU's math libraries, set before torch loads them:
# the loop is host-bound, and a pool of threads contending with its one
# Python thread and the frame prefetch thread only adds spread.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

from vo_bench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
