"""Sharded solves over torch.distributed (the JAX package's parallel/):
group.py (SolverOptions.mesh's ranks and their collectives), launch.py
(run_ranks), sharded_fused.py (the sharded fused Schur solve), sharded.py
(the sharded CGNR and Schur steps), solve_sharded.py (solve's route) and
dryrun.py (dryrun_multichip)."""
