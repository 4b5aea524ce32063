"""Host time that stages one labeling forward, in ms: the program's
windows cut from the history (``vpt_torch.labeler.cut``), stacked into a
group (``vpt_torch.labeler.stack``) and copied through pinned memory
(``vpt_torch.idm.upload``), summed over the profiled stretch and divided
by its forwards (one upload each)."""

from portbench.spans import durations_ms


def read(run):
    uploads = durations_ms(run, "label", "vpt_torch.idm.upload")
    if not uploads:
        return None
    staging = [sum(durations_ms(run, "label", f"vpt_torch.labeler.{part}")) for part in ("cut", "stack")]
    return (sum(uploads) + sum(staging)) / len(uploads)
