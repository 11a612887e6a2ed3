"""One module per arrival process of a traffic mix, found by the mix's
`arrival` (portbench/generator.py)."""
