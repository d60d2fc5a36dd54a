"""Host-side utilities of ceres_tpu_torch (timing)."""
