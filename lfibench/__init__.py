"""The benchmark of ``lfinterpolator_tpu_torch`` on one NVIDIA GPU.

Entry: ``python3 lfibench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``BENCHMARK.json`` at the root of the checkout names the
cells). What belongs to one configuration, traffic mix or per-layer metric
is a file of its own, found by its name:

  configs/<config>.json    the deployment: grid, image size, views, method,
                           focus window, scene; its source, assumed, reduced
  traffic/<mix>.json       a traffic mix: the generator that runs it and its
                           parameters, the answers sampled for the check and
                           the limit of each number the check compares
  traffic/<generator>.py   a traffic generator (``api_loop``, ``stream``)
  metrics/<metric>.py      a metric's reader: ``read(record)`` -> number or
                           None
  roofline.py              the bytes and operations of each kernel's work,
                           and the card's published peaks
  reference/               the plain reference the check compares with
"""
