"""The benchmark of vectorindex_tpu_torch on NVIDIA H100 cards.

One command runs one cell once (`python3 -m portbench --help`); run.py says
how a run goes, BENCHMARK.json at the repository root names the cells and
metrics, and configs/, traffic/, indexes/ and metrics/ hold what belongs
to one configuration, one traffic mix (load.py generates it), one index
type and one metric. control.py measures the
comparison's control on the card. Nothing here imports jax or the JAX
package, and nothing of the port but its public API.
"""
