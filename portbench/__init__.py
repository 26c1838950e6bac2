"""The benchmark of tpurag_torch, the PyTorch + CUDA port: one cell run
by ``python3 portbench/run.py --workload NAME --seed N --seconds S
--trace 0|1`` from the root of a checkout (BENCHMARK.json lists the
cells). It imports the port and never jax or the JAX package."""
