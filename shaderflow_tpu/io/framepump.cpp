// framepump: multithreaded frame writer — the TurboPipe equivalent.
//
// Role (see SURVEY.md §2.9): the reference uses the author's TurboPipe C++
// extension to overlap GL PBO readbacks with pipe writes to FFmpeg's stdin
// (exporting.py:162-171). Here the producer is the device->host transfer
// of a uint8 frame batch; this pump gives the same overlap on the host side:
// submit() memcpys a frame into a pinned ring slot and returns immediately,
// while a worker thread drains slots to the output fd in submission order.
// The render/transfer of batch k+1 proceeds while batch k is still being
// encoded.
//
// Build: g++ -O3 -shared -fPIC -o libframepump.so framepump.cpp -lpthread
// API (C, ctypes-friendly):
//   void*  pump_create(int fd, size_t slot_size, int n_slots)
//   long   pump_submit(void* pump, const void* data, size_t len)  // 0 ok, <0 error
//   long   pump_flush(void* pump)                                  // wait until drained
//   long   pump_destroy(void* pump)                                // flush + join; status
//   long   pump_error(void* pump)                                  // sticky errno (0 = ok)

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <unistd.h>

namespace {

struct Slot {
    std::vector<char> data;
    size_t filled = 0;
};

struct Pump {
    int fd = -1;
    size_t slot_size = 0;
    std::vector<Slot> slots;
    std::deque<int> queue;     // slots pending write, in submission order
    std::deque<int> free_list; // slots available for submit
    std::mutex mutex;
    std::condition_variable cv_submit; // signaled when a slot frees up
    std::condition_variable cv_drain;  // signaled when the queue empties
    std::thread worker;
    std::atomic<long> error{0};
    bool stopping = false;

    void run() {
        for (;;) {
            int index;
            {
                std::unique_lock<std::mutex> lock(mutex);
                cv_submit.wait(lock, [&] { return stopping || !queue.empty(); });
                if (queue.empty()) {
                    if (stopping) return;
                    continue;
                }
                index = queue.front();
                queue.pop_front();
            }

            Slot &slot = slots[index];
            const char *ptr = slot.data.data();
            size_t remaining = slot.filled;
            while (remaining > 0 && error.load() == 0) {
                ssize_t wrote = ::write(fd, ptr, remaining);
                if (wrote < 0) {
                    if (errno == EINTR) continue;
                    error.store(-(long)errno);
                    break;
                }
                ptr += wrote;
                remaining -= (size_t)wrote;
            }

            {
                std::lock_guard<std::mutex> lock(mutex);
                slot.filled = 0;
                free_list.push_back(index);
                cv_submit.notify_all();
                if (queue.empty()) cv_drain.notify_all();
            }
        }
    }
};

} // namespace

extern "C" {

void *pump_create(int fd, size_t slot_size, int n_slots) {
    if (n_slots < 1 || slot_size == 0) return nullptr;
    Pump *pump = new Pump();
    pump->fd = fd;
    pump->slot_size = slot_size;
    pump->slots.resize((size_t)n_slots);
    for (int i = 0; i < n_slots; i++) {
        pump->slots[(size_t)i].data.resize(slot_size);
        pump->free_list.push_back(i);
    }
    pump->worker = std::thread(&Pump::run, pump);
    return pump;
}

long pump_submit(void *handle, const void *data, size_t len) {
    Pump *pump = static_cast<Pump *>(handle);
    if (!pump || len > pump->slot_size) return -EINVAL;
    long err = pump->error.load();
    if (err != 0) return err;

    int index;
    {
        std::unique_lock<std::mutex> lock(pump->mutex);
        pump->cv_submit.wait(lock, [&] { return !pump->free_list.empty() || pump->error.load() != 0; });
        err = pump->error.load();
        if (err != 0) return err;
        index = pump->free_list.front();
        pump->free_list.pop_front();
    }

    Slot &slot = pump->slots[(size_t)index];
    std::memcpy(slot.data.data(), data, len);
    slot.filled = len;

    {
        std::lock_guard<std::mutex> lock(pump->mutex);
        pump->queue.push_back(index);
        pump->cv_submit.notify_all();
    }
    return 0;
}

long pump_flush(void *handle) {
    Pump *pump = static_cast<Pump *>(handle);
    if (!pump) return -EINVAL;
    std::unique_lock<std::mutex> lock(pump->mutex);
    pump->cv_drain.wait(lock, [&] {
        return (pump->queue.empty() && pump->free_list.size() == pump->slots.size())
               || pump->error.load() != 0;
    });
    return pump->error.load();
}

long pump_error(void *handle) {
    Pump *pump = static_cast<Pump *>(handle);
    return pump ? pump->error.load() : -EINVAL;
}

long pump_destroy(void *handle) {
    Pump *pump = static_cast<Pump *>(handle);
    if (!pump) return -EINVAL;
    pump_flush(pump);
    {
        std::lock_guard<std::mutex> lock(pump->mutex);
        pump->stopping = true;
        pump->cv_submit.notify_all();
    }
    pump->worker.join();
    long err = pump->error.load();
    delete pump;
    return err;
}

} // extern "C"
