"""The benchmark's plain reference of stringsext's output.

Every module here except `regions.py` is a frozen copy of the port's host
engine as it stood when the benchmark was written (`options.py`,
`mission.py`, `finding.py`, `encodings/` with the WHATWG index tables,
`engine/events*.py` and `engine/automaton.py`): numpy decoders that turn
bytes into decode events and the Python emission automaton that replays
the reference CLI's slices, windows and carry state. The scan the
benchmark times never runs them (it runs the device feed and the C++
emitter), and later changes to the port do not reach these copies, so
they judge the port from outside. Nothing here imports the port, JAX or
the JAX package.

`regions.py` cuts an image at slice boundaries where every mission's
carry state is provably empty and gives the exact output lines of each
region between two such boundaries.
"""
