"""Device side of the batch path: the plain scan, the fused CUDA scan and
the backend that drives them."""
