"""Parameters, metrics, transforms and device simulators on tensors."""
