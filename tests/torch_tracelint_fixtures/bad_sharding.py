"""sharding-axes fixture: literal axis names the mesh does not declare."""
from repro_torch.distributed.sharding import AxisMesh, MeshRules, axis_index


def rules(mesh):
    r = MeshRules(mesh=mesh, batch=("batch", "rows"), ac="ac")
    n = r.axis_size("tensor")
    i = axis_index({"ac": 0}, "acc")
    m = AxisMesh({"data": 2, "expert": 4})
    return r, n, i, m, mesh.shape["pods"]
