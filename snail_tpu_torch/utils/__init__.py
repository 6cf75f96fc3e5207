"""Host-side statistics records."""
