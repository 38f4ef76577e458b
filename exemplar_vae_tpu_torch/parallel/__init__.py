"""Bank sharding over torch.distributed: the mesh (mesh.py), the sharded
exact prior (sharded_prior.py) and the sharded approximate-kNN prior
(sharded_knn.py)."""
