# Synthetic data of the benchmarks (numpy, made from a seed).
