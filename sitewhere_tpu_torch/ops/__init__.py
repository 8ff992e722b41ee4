"""Device ops of the hot path: wire pack/unpack, rules, geofence (plain +
CUDA kernel), keyed folds, alert-lane compaction."""
