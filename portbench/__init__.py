"""The benchmark of maua_tpu_torch on an NVIDIA H100: data-driven cells
(BENCHMARK.json at the repository's root), a plain fp32 StyleGAN2 reference
that decides `correct`, and the work counts behind the roofline and MFU
metrics. `python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once."""
