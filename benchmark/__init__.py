"""The benchmark of ``lz4_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell is made of is a file found by its name:
``configs/<config>.json`` (which names its codec, ``codecs/<codec>.py``),
``traffic/<traffic>.json`` (which names its pipeline,
``pipelines/<pipeline>.py``) and ``metrics/<metric>.py``. The yardstick
(the data, the plain reference, the roofline arithmetic and the
comparison) imports nothing of the program; ``system.py`` and the codecs'
``program`` functions are what call it.
"""
