"""Host-side IO: read loading, batching, data generation, device feeding."""
