"""matvecs_per_request.direct: the lambda-GMRES result's ``num_matvec`` per
request on the direct path, where each matvec is one wave cycle (K1)
(``matvecs_per_request.lambda``'s reading)."""

from benchmark import spec

read = spec.load_module(spec.HERE, "metrics", "matvecs_per_request.lambda").read
