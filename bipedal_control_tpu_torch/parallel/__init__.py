from .batch_solver import batched_sqp_solve, make_batched_solver, make_mesh, shard_batch
