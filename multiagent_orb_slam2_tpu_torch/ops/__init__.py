"""Feature front end: pyramid, FAST, rBRIEF, Hamming matching, stereo.
Fixed-shape, batched tensor code; descriptors are ``[*, 8] int32`` holding
the bit pattern of the JAX package's ``uint32`` words."""
