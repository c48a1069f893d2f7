"""The benchmark of lc3jax_torch on one NVIDIA H100: closed-loop decode and
encode of many LC3 streams through `serving.BatchDecoder` and
`serving.BatchEncoder`, host memory in and out (`python -m codecbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`).

It imports nothing of JAX or of the JAX package, and judges the program
against its own frozen numpy reference (`codecbench/ref`).
"""
