"""The benchmark of ``tpu_dist_torch`` on NVIDIA H100 cards.

``BENCHMARK.json`` at the root of the repository names the cells; this
package runs one cell once (``python3 gpubench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``) and prints one JSON line.

Everything that belongs to one configuration, traffic mix, entry, metric
or cell is a file of its own, found by its name:

* ``configs/<config>.json``: the sizes as they are run, their source,
  ``reduced`` and ``assumed``;
* ``models/<config>.py``: how the port builds that model, and the names,
  shapes and initial distributions of its weights;
* ``traffic/<traffic>.json``: the parameters the one generator
  (:mod:`gpubench.traffic`) and the entry read;
* ``entries/<entry>.py``: the program's call that the window drives;
* ``metrics/<metric>.py``: the reader of one metric;
* ``limits/<workload>.json``: the limits of the numbers ``correct``
  compares in that cell, with the readings they were set from.

The yardstick is frozen here: the work formulas and peaks
(:mod:`gpubench.flops`), the window and trace arithmetic
(:mod:`gpubench.stats`, :mod:`gpubench.trace`), and the plain float32
reference (:mod:`gpubench.reference`), which imports nothing of the port.
"""
