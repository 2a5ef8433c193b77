"""The eager core: dtypes, the Tensor over torch autograd, op dispatch."""
