"""The benchmark's yardstick: cell lookup, traffic, counts, statistics,
the trace reduction, seeded inputs and the result line. Nothing here
imports the program (``ray_tpu_torch``); the modules under ``drivers/``
do."""
