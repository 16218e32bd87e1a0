"""The share of a request's rows that the count kernel walked one row an
item (the program's ``single_rows.batched_count``) among every row it was
launched with (``tiled_rows.batched_count`` besides), in the traced
requests.  A row walked alone reads the corpus for itself; a row of a
group shares each corpus tile with the group.  It reads nothing where no
row was walked alone, and so nothing from a program without the counter."""

from portbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or run.op != "count":
        return None
    single = rec.count("single_rows.batched_count")
    if not single:
        return None
    return 100.0 * single / (single + rec.count("tiled_rows.batched_count"))
