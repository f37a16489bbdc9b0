"""Host-side geometry, camera, spline and timing helpers of the port."""
