"""The entry points a window drives, one module each, named by a traffic
mix's ``entry``.  Each module has

* ``TRAFFIC``: the traffic keys it reads, besides ``entry``; a mix with
  any other key is refused (:meth:`benchmark.harness.Cell.entry`), so that
  a mix that needs other code comes with an entry of its own;
* ``FAULTS``: the faults its cells take, each name with the context
  manager that plants it under the timed path (``benchmark/faults.py``);
* ``CPU_SIZES``: the ``traffic`` keys, and the ``config`` keys, that its
  cells take in the CPU tests, a size a CPU holds on the same code paths;
* ``Session(config, traffic, seed, device)``: set-up, the inputs and
  weights from the seed, the program built and its shapes warmed;
* ``Session.window(seconds, trace_calls)``: the window, its end-to-end
  numbers, what the metric readers read (``model_flops``, a network's
  ``conv_bound_s``), and with ``trace_calls`` that many calls traced;
* ``Session.release()``: the program's objects dropped, the inputs and
  the sampled outputs kept;
* ``judge(config, traffic, inputs, outputs, device)``: the numbers that
  decide ``correct``, from the plain reference;
* ``control_outputs(...)``: the reference one precision step lower, as
  outputs to judge in the program's place.
"""

import math
from typing import Iterable


def widest(values: Iterable[float]) -> float:
    """The largest of ``values``; NaN if any is NaN (Python's max would
    pass over it)."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values)
