"""Traffic drivers: one per traffic `mode`, each reading the parameters
of a traffic file under benchmark/traffic/."""
