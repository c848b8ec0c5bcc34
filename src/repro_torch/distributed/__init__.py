"""Device placement of the port's multi-device trainer: the ("ac",
"batch") mesh, its rules, and the one function that moves a tensor
between groups."""
