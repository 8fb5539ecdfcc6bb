from repro_torch.planner.api import ServePlan, serve_plan  # noqa: F401
