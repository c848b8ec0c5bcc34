"""sharding-axes control: declared axes only (the default universe of a
scan that declares none)."""
from repro_torch.distributed.sharding import AxisMesh, MeshRules, axis_index


def rules(mesh):
    r = MeshRules(mesh=mesh, batch=("batch",), ac="ac")
    n = r.axis_size(("data", "model"))
    i = axis_index({"ac": 0}, "ac")
    m = AxisMesh({"pod": 2, "data": 4})
    return r, n, i, m, mesh.shape["batch"]
