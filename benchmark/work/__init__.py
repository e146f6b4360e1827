"""Operation and byte counts of the cells' work (`counts`)."""
