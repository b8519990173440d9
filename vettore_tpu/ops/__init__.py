"""Device kernels and pure algorithm helpers (the accelerator equivalent of the
reference's Rust compute core, /root/reference/native/vettore/src/)."""
