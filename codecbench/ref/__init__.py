"""The benchmark's plain reference: a float32-faithful NumPy LC3 encoder and
decoder, scalar per frame.

A frozen copy of the repository's numpy oracle with its tables and frame
geometry, importing only numpy, ctypes and its own files: the benchmark
judges the measured program against it, and no change to the program can
change it. Its encoder reproduces the Bluetooth SIG reference codec's
frames byte for byte and its decoder the reference PCM
(`codecbench/tests/test_codecbench_reference.py` holds it to the
repository's goldens).
"""
