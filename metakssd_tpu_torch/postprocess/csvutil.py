"""Ports of the reference csv-subset helper scripts
(reference src/csv_table_subset.pl, src/ordcsv_table_subset.pl).

Both take a comma-separated table and a tab-separated selection list and
emit matching rows by first-column id; `ordered=True` preserves the
*selection* order and prints ``==no match==`` for absent ids (the
ordcsv variant), `ordered=False` preserves the csv order and drops
non-selected rows silently.
"""

from __future__ import annotations


def csv_table_subset(csv_lines, select_lines, out=None) -> None:
    """Rows of csv_lines whose first (comma) field appears as the first
    (tab) field of any selection line, in csv order
    (reference src/csv_table_subset.pl)."""
    import sys
    out = out or sys.stdout
    wanted = set()
    for line in select_lines:
        line = line.rstrip("\n")
        wanted.add(line.split("\t")[0])
    for line in csv_lines:
        line = line.rstrip("\n")
        if line.split(",")[0] in wanted:
            out.write(line + "\n")


def ordcsv_table_subset(csv_lines, select_lines, out=None) -> None:
    """One output row per selection line, in selection order; unmatched
    ids print ``==no match==`` (reference src/ordcsv_table_subset.pl;
    later duplicate csv ids win, matching the Perl hash overwrite)."""
    import sys
    out = out or sys.stdout
    rows: dict[str, str] = {}
    for line in csv_lines:
        line = line.rstrip("\n")
        rows[line.split(",")[0]] = line
    for line in select_lines:
        line = line.rstrip("\n")
        key = line.split("\t")[0]
        out.write(rows.get(key, "==no match==") + "\n")
