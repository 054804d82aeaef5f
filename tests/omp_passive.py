"""Imported by every port test file before ``torch``.

The OpenMP runtime torch loads on the CPU (libgomp) reads its wait policy
once, when it loads.  The suite runs many processes on the same cores (the
xdist workers, the mesh tests' ranks and JAX subprocesses); under the
default policy an idle OpenMP thread spins before it sleeps, so a process
of many small ops waits at every parallel region on threads that spin in
the other processes, and the port's CPU tests ran about a hundred times
slower in the suite than alone.  A passive thread sleeps at once; the
thread count and the work each thread does are unchanged, and with them
every float."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
