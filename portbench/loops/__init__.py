"""How a window serves its traffic, one module a kind (``loops/<kind>.py``),
named by a traffic mix's ``"loop"``.

A loop module provides:

- ``SERVES``: the name of the ``Session`` method that serves one unit,
  ``(unit, j) -> record``;
- ``units(session)``: the units in arrival order, drawn from
  ``session.requests()``;
- ``traced_enough(mix, traced) -> bool``: whether the traced part, the
  units ``traced`` in order, is complete;
- ``tally(run) -> (attempted, failed)``: the requests attempted and failed
  over the window's records.
"""
