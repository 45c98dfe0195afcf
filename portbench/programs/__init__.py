"""The programs a cell can drive, one module a kind (``programs/<kind>.py``),
named by a configuration file's ``"program"`` (``tts`` where it is absent).

A program module provides:

- ``prepare(device) -> dict``: what the program builds once a process
  (kernels), as set-up parts in seconds; may be empty;
- ``specs(cfg)`` / ``draw(cfg, seed, device)``: its weights, drawn from the
  seed on the device;
- ``Session(cfg, mix, seed, device)``: the program with its inputs, with
  ``setup_times`` (seconds of each part of its set-up), ``warm_up()``,
  ``requests()`` (the traffic's requests in arrival order), ``counters()``
  (the program's own counts, such as kernel launches: the window keeps
  their change), ``taps.on`` (observers of what the timed path produces,
  on while the window runs), ``spans`` (``on``; ``spans``, the (name, t0,
  t1) of the traced part; ``stopwatch()``, a context under which the
  program's phases are logged there), ``close()``, and for each loop kind
  it serves the method that loop names (``(unit, j) -> record``);
- ``reference_args(session) -> dict``, ``Reference(cfg, seed, device,
  control=False, **args)`` and ``numbers(session, run, ref) -> {name:
  value}``: the comparison with the plain reference that decides
  ``correct``, each number against ``limits/<cell>.json``;
- ``flops(cfg, record)``: the model FLOPs of a record (the ``mfu`` readers);
- ``span_log()``: the program's own finished spans (``name``, ``t0``,
  ``t1``, ``ms``, ``host_ms``, ``counters``), or None where it keeps none;
- ``describe(run) -> [line]`` (optional): diagnostics for standard error.

A record is a dict with at least ``i``, ``t0`` and ``t1`` (the unit's start
and end on ``time.perf_counter``); the window records a unit that raised as
``{"i", "failed": True, "t1"}``. Metric readers read the further keys the
program documents on its serving methods.
"""
