"""The port's benchmark: ``python3 port_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once on the card
and prints one JSON line."""
