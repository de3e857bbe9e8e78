"""The plain reference that decides ``correct``: a frozen copy of the
port's eager route with every hand-written kernel replaced by its plain
torch version (``kernels/``), so that it imports nothing of
``ptzjax_torch`` (nor ``jax`` or ``ptzjax``) and takes nothing the port
made. ``loop.py`` is its entry: the same bootstrap, re-detect and KLT loops
as ``PTZSlam``, run frame by frame with a host ``if`` at each branch.

The copy is frozen: a later change to the port's code does not move the
yardstick. The harness hands it the same frames as the program, and for a
segment that does not start at ``init``, the program's state at the
segment's start (see ``ptzbench/check.py``).
"""
