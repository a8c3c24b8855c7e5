from .metrics import add_err, adds_err, compute_auc, rotation_geodesic_deg  # noqa: F401
