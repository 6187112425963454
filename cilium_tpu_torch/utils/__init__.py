"""Host helpers shared by several layers."""
