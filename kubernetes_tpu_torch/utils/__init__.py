"""Host utilities: metrics and slow-operation traces."""
