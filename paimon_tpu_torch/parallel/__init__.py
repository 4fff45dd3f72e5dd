"""Host-side thread pools of the write and scan paths."""
