"""Plain reference models, one file a model, found by the name a
configuration gives under "reference_model". Each file defines
`make(params: dict, N: int) -> RefModel` (see `benchmark.reference.model`)."""
