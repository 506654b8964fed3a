"""Placebo plan — the port's torch transcription of ``plans/placebo``'s
sim plan. ``stall`` sleeps for 24 hours of virtual time, so it ends at
``SimConfig.max_ticks`` with its instances still running."""


def ok(b):
    b.log("placebo ok")
    b.end_ok()


def panic(b):
    b.log("this is an intentional panic")
    b.end_crash()


def stall(b):
    b.log("Now stalling for 24 hours")
    b.sleep_ms(24 * 3600 * 1000)
    b.end_ok()


def abort(b):
    b.end_fail()


def metrics(b):
    b.record_point("a_result_metric", lambda env, mem: 1.0)
    b.record_point("a_timer", lambda env, mem: 0.25)
    b.end_ok()


testcases = {
    "ok": ok,
    "panic": panic,
    "stall": stall,
    "abort": abort,
    "metrics": metrics,
}
