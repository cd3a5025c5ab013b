"""Ray ops on tensors: geometry, encodings, sampling, compositing."""
