"""GATv2 model and its parameter IO."""
